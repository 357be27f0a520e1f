"""frave_tpu_torch elementwise ops and lifting kernels against frave_tpu.

The same seeded numpy inputs go through jax_ops (and the Pallas lifting
kernels in interpret mode) and the port's functions on the CPU; every
comparison is bit-exact: the ops are integer or a fixed f32 op sequence.
Kernel A's plain version (the encode head: channel transform, leaf
gather, forward lifting, quantize, zero slot) is held against the JAX
program's transform and gather followed by the Pallas kernel, and kernel
B's (dequantize + inverse lifting + the decode tail) against the Pallas
kernel followed by the JAX program's pixel gather, clamp and inverse
transform, both on the pixel maps of real programs. The kernels' own
check on the card is in test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from frave_tpu.ops import jax_ops as J
from frave_tpu_torch.ops import lifting as L
from frave_tpu_torch.ops import torch_ops as T


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_trunc_div_negatives():
    rng = np.random.default_rng(0)
    a = rng.integers(-5000, 5000, size=4096).astype(np.int32)
    a[:6] = [-1, -2, -3, -7, 0, 7]
    for q in (1, 2, 3, 7, 24):
        ref = np.asarray(J.trunc_div(jnp.asarray(a), q))
        np.testing.assert_array_equal(T.trunc_div(_t(a), q).numpy(), ref)
    assert T.trunc_div(torch.tensor([-7], dtype=torch.int32), 2).item() == -3


def test_f16_wire_round_special_values():
    rng = np.random.default_rng(1)
    sub = np.float32(2.0 ** -24)
    special = np.array(
        [
            0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 65519.99, 65520.0,
            -65520.0, 1e10, 6.1035156e-05, 6.0975552e-05, 5.96e-08, 2.98e-08,
            2.99e-08, sub, -sub, 1.5 * sub, 2.5 * sub, 1e-30, -1e-30, 1.0,
            1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 0.333333, -7.4609375,
        ],
        dtype=np.float32,
    )
    payload_nan = np.array([0x7FC12345, 0xFFA00001], dtype=np.uint32).view(np.float32)
    subnormals = (rng.integers(0, 2048, 512) * (sub / 4)).astype(np.float32)
    f32_denorm = (rng.integers(1, 1 << 23, 64).astype(np.uint32)).view(np.float32)
    normals = rng.normal(0, 30, 4096).astype(np.float32)
    rand_bits = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([special, payload_nan, subnormals, -subnormals, f32_denorm,
                        normals, rand_bits])
    ref = np.asarray(J.f16_wire_round(jnp.asarray(x)))
    out = T.f16_wire_round(_t(x)).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    # and the IEEE conversion itself wherever it is defined (not NaN)
    ok = ~np.isnan(x)
    with np.errstate(over="ignore"):
        ieee = x[ok].astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(_bits(out[ok]), _bits(ieee))


def test_assign_bucket_nan_and_negative_widths():
    from frave_tpu.entropy.tables import BUCKET_EDGES

    edges = np.asarray(BUCKET_EDGES, dtype=np.float32)
    w = np.concatenate(
        [
            np.array([np.nan, -np.nan, -1.0, -0.0, 0.0, np.inf, -np.inf], np.float32),
            edges,
            np.nextafter(edges, np.float32(-np.inf)),
            np.random.default_rng(2).uniform(-5, 60, 2048).astype(np.float32),
        ]
    )
    ref = np.asarray(J.assign_bucket_f32(jnp.asarray(w)))
    np.testing.assert_array_equal(T.assign_bucket_f32(_t(w)).numpy(), ref)


@pytest.mark.parametrize("lf", [False, True])
def test_contexts_static_bit_exact(lf):
    rng = np.random.default_rng(3 + lf)
    vals = rng.integers(-511, 512, size=(3, 500, 6)).astype(np.int32)
    vals[:, :40] = 0  # flat contexts (all gradient features zero)
    vp = rng.normal(0, 0.5, size=(3, 1, 6)).astype(np.float32)
    wp = rng.normal(0, 0.3, size=(3, 1, 6)).astype(np.float32)
    wp[0, 0, 0] = np.nan  # NaN widths land in bucket 0
    vp[1, 0, 2] = np.inf  # inf predictions clamp
    rb, rp = J.contexts_static(jnp.asarray(vals), jnp.asarray(vp), jnp.asarray(wp), lf)
    b, p = T.contexts_static(_t(vals), _t(vp), _t(wp), lf)
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))


def test_contexts_per_symbol_groups():
    rng = np.random.default_rng(5)
    K, F = 700, 11
    vals = rng.integers(-300, 300, size=(2, K, 6)).astype(np.int32)
    lf = rng.random(K) < 0.3
    grp = rng.integers(0, F, K).astype(np.int32)
    vp = rng.normal(0, 0.5, size=(2, F, 6)).astype(np.float32)
    wp = rng.normal(0, 0.5, size=(2, F, 6)).astype(np.float32)
    rb, rp = jax.vmap(lambda v, a, b: J.contexts(v, jnp.asarray(lf), jnp.asarray(grp), a, b))(
        jnp.asarray(vals), jnp.asarray(vp), jnp.asarray(wp)
    )
    b, p = T.contexts(_t(vals), _t(lf), _t(grp.astype(np.int64)), _t(vp), _t(wp))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))


def test_pack_unpack_signed():
    k = np.arange(-600, 600, dtype=np.int32)
    packed = T.pack_signed(_t(k))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(J.pack_signed(jnp.asarray(k))))
    s = np.arange(0, 1024, dtype=np.int32)
    np.testing.assert_array_equal(
        T.unpack_signed(_t(s)).numpy(), np.asarray(J.unpack_signed(jnp.asarray(s)))
    )
    np.testing.assert_array_equal(T.unpack_signed(packed).numpy(), k)


def _run_interpret(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


@pytest.mark.parametrize("depth,T_", [(9, 130), (7, 64)])
def test_forward_lift_quantize_plain(depth, T_):
    from frave_tpu.ops.pallas_lifting import forward_lift_quantize

    rng = np.random.default_rng(10 + depth)
    n = 1 << depth
    leaves = rng.integers(0, 256, size=(T_, n)).astype(np.int32)
    mask = rng.random((T_, n)) > 0.15
    leaves = np.where(mask, leaves, 0).astype(np.int32)
    qdiv = np.ones(n, np.int32)
    qdiv[n // 2 :] = 3
    qdiv[n // 4 : n // 2] = 2
    ref = np.asarray(
        J.quantize(
            J.forward_lifting(jnp.asarray(leaves)[None], jnp.asarray(mask)[None], depth),
            jnp.asarray(qdiv)[None, None, :],
        )
    )[0]
    pallas = np.asarray(
        _run_interpret(
            forward_lift_quantize, jnp.asarray(leaves.T), jnp.asarray(mask.T),
            jnp.asarray(qdiv), depth,
        )
    ).T
    np.testing.assert_array_equal(pallas, ref)
    out = L.forward_lift_quantize_plain(_t(leaves), _t(mask.astype(np.uint8)), _t(qdiv), depth)
    np.testing.assert_array_equal(out.numpy(), ref)
    # the mask is per tile: two "channels" of the same tiles share it
    out2 = L.forward_lift_quantize_plain(
        _t(np.concatenate([leaves, leaves])), _t(mask), _t(qdiv), depth
    )
    np.testing.assert_array_equal(out2.numpy(), np.concatenate([ref, ref]))


@pytest.mark.parametrize("depth,T_", [(9, 130), (7, 64)])
def test_dequantize_inverse_lift_plain(depth, T_):
    from frave_tpu.ops.pallas_lifting import dequantize_inverse_lift

    rng = np.random.default_rng(20 + depth)
    n = 1 << depth
    qcoef = rng.integers(-80, 80, size=(T_, n)).astype(np.int32)
    node_mask = rng.random((T_, n)) > 0.1
    leaf_mask = rng.random((T_, n)) > 0.1
    qdiv = np.ones(n, np.int32)
    qdiv[n // 4 :] = 2
    qdiv[n // 2 :] = 5
    ref = np.asarray(
        J.inverse_lifting(
            J.dequantize(jnp.asarray(qcoef)[None], jnp.asarray(qdiv)[None, None, :]),
            depth, jnp.asarray(node_mask)[None], jnp.asarray(leaf_mask)[None],
        )
    )[0]
    pallas = np.asarray(
        _run_interpret(
            dequantize_inverse_lift, jnp.asarray(qcoef.T), jnp.asarray(node_mask.T),
            jnp.asarray(leaf_mask.T), jnp.asarray(qdiv), depth,
        )
    ).T
    np.testing.assert_array_equal(pallas, ref)
    out = L.dequantize_inverse_lift_plain(
        _t(qcoef), _t(node_mask), _t(leaf_mask.astype(np.uint8)), _t(qdiv), depth
    )
    np.testing.assert_array_equal(out.numpy(), ref)


def test_wrappers_reject_bad_operands():
    m = torch.ones((4, 512), dtype=torch.uint8)
    q = torch.ones(512, dtype=torch.int32)
    pix = torch.zeros(4 * 512, dtype=torch.int32)
    # kernel A: a wrong dtype, a leaf_pix that is not T*512, a bad transform
    # id, C not in {1, 3}, a qdiv that is not [512]
    px = torch.zeros((16, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        L.forward_lift_quantize_pixels(px.to(torch.int32), pix, q, 0)
    with pytest.raises(TypeError):
        L.forward_lift_quantize_pixels(px, pix.to(torch.int64), q, 0)
    with pytest.raises(ValueError):
        L.forward_lift_quantize_pixels(px, pix[:-1], q, 0)
    with pytest.raises(ValueError):
        L.forward_lift_quantize_pixels(px, pix, q, 4)
    with pytest.raises(ValueError):
        L.forward_lift_quantize_pixels(torch.zeros((16, 2), dtype=torch.uint8), pix, q, 0)
    with pytest.raises(ValueError):
        L.forward_lift_quantize_pixels(px, pix, q[:256], 0)
    # kernel B: a non-contiguous row, depth 7, a bad transform id
    inv = torch.zeros(16, dtype=torch.int64)
    plane = torch.zeros((3, 4 * 512), dtype=torch.int32)
    with pytest.raises(ValueError):
        L.dequantize_inverse_lift_pixels(plane.T.contiguous().T, m, m, q, pix, inv, 0)
    with pytest.raises(ValueError):
        L.dequantize_inverse_lift_pixels(plane, m[:, :128], m[:, :128], q[:128], pix, inv, 0)
    with pytest.raises(ValueError):
        L.dequantize_inverse_lift_pixels(plane, m, m, q, pix, inv, 4)


def _lift_head_reference(pixels, qdiv, tid, h, w):
    """frave_tpu's encode head (pipeline_jax's encode before the
    statistics): pixels.T, _transform_device at C = 3, the leaf_safe
    gather under leaf_mask (the JAX package's geometry), the Pallas
    forward_lift_quantize in interpret mode on the [N, C*T] layout, and
    the zero slot appended to every channel row."""
    from frave_tpu.codec.pipeline_jax import _transform_device
    from frave_tpu.fractal.geometry import get_geometry
    from frave_tpu.ops.pallas_lifting import forward_lift_quantize

    C = pixels.shape[1]
    pg = get_geometry(h, w, 9).pixel_gather.astype(np.int64)
    Tn, n = pg.shape
    leaf_mask = jnp.asarray(pg >= 0)
    planes = jnp.asarray(pixels).T.astype(jnp.int32)
    if C == 3:
        planes = _transform_device(planes, jnp.int32(tid))
    leaves = jnp.where(leaf_mask[None], planes[:, jnp.asarray(np.where(pg >= 0, pg, 0))], 0)
    nt = leaves.astype(jnp.int32).transpose(2, 0, 1).reshape(n, C * Tn)
    mt = jnp.broadcast_to(leaf_mask.T[:, None, :], (n, C, Tn)).reshape(n, C * Tn)
    q = _run_interpret(forward_lift_quantize, nt, mt, jnp.asarray(qdiv), 9)
    qcoef = np.asarray(q).reshape(n, C, Tn).transpose(1, 2, 0).reshape(C, Tn * n)
    return np.concatenate([qcoef, np.zeros((C, 1), np.int32)], axis=1)


@pytest.mark.parametrize("qkind", ["lossy", "lossless"])
@pytest.mark.parametrize(
    "h,w,c,tid", [(64, 64, 1, 0)] + [(96, 80, 3, tid) for tid in range(4)]
)
def test_forward_lift_quantize_pixels_plain_matches_jax(h, w, c, tid, qkind):
    """Kernel A's function (the encode head) on a real program's pixel map
    (the 64x64 gray and 96x80 RGB programs), every transform id at C = 3,
    a lossy qdiv (1/2/3) and the lossless one; tolerance 0: the function
    is integer-only."""
    from frave_tpu_torch.kernel_check import lift_head_problem, program

    prog = program(h, w, c, "cpu")
    args, extra = lift_head_problem(np.random.default_rng(40 + tid), prog, tid, qkind)
    pixels, _, qdiv = (a.numpy() for a in args)
    ref = _lift_head_reference(pixels, qdiv, tid, h, w)
    assert ref.shape == (c, prog.num_tiles * 512 + 1)
    assert (ref[:, :-1] < 0).any()  # the truncated divide meets negative coefficients
    before = L.forward_lift_quantize_pixels.launches
    out = L.forward_lift_quantize_pixels(*args, *extra)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[:, -1] == 0).all()  # the zero slot
    assert L.forward_lift_quantize_pixels.launches == before  # CPU: no kernel


@pytest.mark.parametrize(
    "c,tiles,want",
    # the smoke's images on 132 SMs (256x256 gray, 512x512 gray, 768x512
    # RGB, 2048x2048 RGB), a one-tile image, and 2048x2048 gray
    [(1, 160, 2), (1, 578, 5), (3, 844, 4), (3, 8453, 5), (3, 1, 2), (1, 8453, 13)],
)
def test_forward_lift_plan(c, tiles, want):
    """Kernel A's launch rule: the least work on the busiest SM, a tie to
    the larger count, always within 2 .. 16 // C; the picks the smoke's
    sweeps found fastest on an H100."""
    assert L.forward_lift_plan(c, tiles, 132) == want


def test_forward_lift_plan_batch():
    """The rule counts every image's blocks: the 64-image 256x256 gray
    batch (10,240 tiles) takes 16 tiles a block, the sweep's fastest, where
    one image takes 2."""
    assert L.forward_lift_plan(1, 160, 132, 64) == 16
    assert L.forward_lift_plan(1, 160, 132, 1) == 2


def _lift_pixels_reference(qplane, nm, lm, qdiv, pix_inv, tid):
    """frave_tpu's decode tail: the Pallas dequantize_inverse_lift in
    interpret mode on the [N, C*T] layout, then the pix_inv gather, the
    clip to [0, 255] and pipeline_jax._inverse_transform_device."""
    from frave_tpu.codec.pipeline_jax import _inverse_transform_device
    from frave_tpu.ops.pallas_lifting import dequantize_inverse_lift

    C = qplane.shape[0]
    Tn, n = nm.shape
    qnt = jnp.asarray(qplane[:, : Tn * n].reshape(C, Tn, n)).transpose(2, 0, 1).reshape(n, C * Tn)
    nmt = jnp.broadcast_to(jnp.asarray(nm).T[:, None, :], (n, C, Tn)).reshape(n, C * Tn)
    lmt = jnp.broadcast_to(jnp.asarray(lm).T[:, None, :], (n, C, Tn)).reshape(n, C * Tn)
    leaves = _run_interpret(dequantize_inverse_lift, qnt, nmt, lmt, jnp.asarray(qdiv), 9)
    leaves = leaves.reshape(n, C, Tn).transpose(1, 2, 0)
    planes = jnp.clip(leaves.reshape(C, -1)[:, jnp.asarray(pix_inv)], 0, 255)
    if C == 3:
        planes = _inverse_transform_device(planes, jnp.int32(tid))
    return np.asarray(planes.astype(jnp.uint8))


@pytest.mark.parametrize(
    "h,w,c,tid", [(64, 64, 1, 0)] + [(96, 80, 3, tid) for tid in range(4)]
)
def test_dequantize_inverse_lift_pixels_plain_matches_jax(h, w, c, tid):
    """Kernel B's function on a real program's masks and pixel map (the
    64x64 gray and 96x80 RGB programs), every transform id at C = 3;
    tolerance 0: the function is integer-only."""
    from frave_tpu_torch.kernel_check import lift_pixels_problem, program

    args, extra = lift_pixels_problem(np.random.default_rng(30 + tid), program(h, w, c, "cpu"), tid)
    qplane, nm, lm, qdiv, _, pix_inv = (a.numpy() for a in args)
    ref = _lift_pixels_reference(qplane, nm, lm, qdiv, pix_inv, tid)
    assert ref.shape == (c, h * w)
    assert (ref == 0).any() and (ref == 255).any()  # the clamp binds
    before = L.dequantize_inverse_lift_pixels.launches
    out = L.dequantize_inverse_lift_pixels(*args, *extra)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert L.dequantize_inverse_lift_pixels.launches == before  # CPU: no kernel

