"""The readings that the limits of `correct` are set from, in one process:

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: the seed's pool, a short window of the cell's traffic at
its own load (the set-up's program built once for every seed), then the
judgement twice over the same kept outputs: as a run makes it (the
program's decodes, the sound reading), and with the configuration's
comparison's control in the program's place (for a lossless one, the
reference computing its contexts in float16, the precision below the
format's float32, decoding the reference's sample).
One JSON line a seed. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(manifest, cell, config, traffic, seeds, seconds, device) -> list:
    from portbench.core import judge as J
    from portbench.core.harness import Program
    from portbench.core.manifest import load_loop
    from portbench.core.pool import make_pool

    prog = Program(config, traffic, device)
    Loop = load_loop(traffic["loop"])
    out = []
    for seed in seeds:
        pool = make_pool(config, seed)
        loop = Loop(prog, pool, seed)
        loop.unit(keep=False)
        prog.sync()
        loop.run_for(seconds)
        sound = J.judge(config, pool, loop.samples, loop.failed, seed)
        control = J.judge(config, pool, loop.samples, loop.failed, seed, control=True)
        out.append({"workload": cell["name"], "seed": seed, "attempted": loop.attempted,
                    "kept": len(loop.samples),
                    "sound": {k: v["value"] for k, v in sound.items()},
                    "control": {k: v["value"] for k, v in control.items()},
                    "sound_correct": J.is_correct(sound),
                    "control_correct": J.is_correct(control)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.core import manifest as M

    man = M.load_manifest()
    cell = M.workload(man, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    for r in readings(man, cell, M.load_config(cell["config"]), M.load_traffic(cell["traffic"]),
                      args.seeds, args.seconds, "cuda"):
        print(json.dumps(r), flush=True)
    print(f"control: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
