"""Device ops: elementwise codec math, the lifting and rANS kernel
wrappers (each beside its plain PyTorch version), and the kernel build."""
