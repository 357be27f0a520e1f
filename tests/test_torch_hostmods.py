"""The port's copies of frave_tpu's host modules against the originals.

frave_tpu_torch keeps its own copies of the numpy host modules it needs
(geometry, lattice grids, the grid schedule, host context tables, the
channel-transform choice, the container and the options), so that it
imports nothing of frave_tpu. Here the same inputs go through both
and every array must be equal: at 64x64, 96x80, 256x256 and 512x512, gray
and RGB where the function sees channels; the schedules of every mode, their
decode steps and stream permutations also at the tiny shapes 16x16, 1x1,
2x511 and 511x2. Every field of the port's dataclasses is compared.

The port's grid wave table against frave_tpu's wave constants, and the
shapes with and without one.

Also: the port's container gives back frave_tpu's bytes for the six golden
fixtures, and tests/data/torch_port_refs.json (the hashes chip_smoke.py
holds the card encodes against) matches a fresh jax encode of its
256x256 gray entry.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from frave_tpu.codec import channel_transform as CTJ
from frave_tpu.codec import grid_decode as GDJ
from frave_tpu.codec import container as CJ
from frave_tpu.codec import options as OJ
from frave_tpu.entropy import tables as HJ
from frave_tpu.fractal import geometry as GJ
from frave_tpu.fractal import lattice as LJ
from frave_tpu.fractal import schedule as SJ
from frave_tpu_torch.codec import channel_transform as CTT
from frave_tpu_torch.codec import grid_decode as GDT
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec import container as CT
from frave_tpu_torch.codec import options as OT
from frave_tpu_torch.entropy import tables as HT
from frave_tpu_torch.fractal import geometry as GT
from frave_tpu_torch.fractal import lattice as LT
from frave_tpu_torch.fractal import schedule as ST
from frave_tpu_torch.testing import natural_image

DATA = os.path.join(os.path.dirname(__file__), "data")
SHAPES = [(64, 64), (96, 80), (256, 256), (512, 512)]
# the step-tensor codec's shapes: two with a dense lattice grid, four
# without one (grid mode decodes them through the step tensors too)
MODE_SHAPES = [(64, 64), (96, 80), (16, 16), (1, 1), (2, 511), (511, 2)]


def assert_same(port, ref, where="."):
    """Recursive equality of the port's value and the reference's:
    dataclasses field by field (the port's fields), arrays by dtype-free
    value and shape, sequences and dicts element by element, enums by
    name."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            assert_same(getattr(port, f.name), getattr(ref, f.name), f"{where}.{f.name}")
    elif isinstance(port, np.ndarray) or isinstance(ref, np.ndarray):
        a, b = np.asarray(port), np.asarray(ref)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(port, dict):
        assert sorted(port) == sorted(ref), where
        for k in port:
            assert_same(port[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), (where, len(port), len(ref))
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{where}[{i}]")
    elif hasattr(port, "name") and hasattr(port, "value") and hasattr(ref, "name"):
        assert (port.name, port.value) == (ref.name, ref.value), where
    else:
        assert port == ref, (where, port, ref)


@pytest.mark.parametrize("h,w", SHAPES)
def test_geometry_matches(h, w):
    geo = GT.get_geometry(h, w)
    assert_same(geo, GJ.get_geometry(h, w))
    assert (geo.nodes_per_tile, geo.num_coef_slots) == (
        GJ.get_geometry(h, w).nodes_per_tile, GJ.get_geometry(h, w).num_coef_slots
    )


@pytest.mark.parametrize("h,w", SHAPES)
def test_grid_schedule_and_row_lane_match(h, w):
    sp, sj = ST.get_schedule(h, w, mode="grid"), SJ.get_schedule(h, w, mode="grid")
    assert_same(sp, sj)
    nl = ST.default_num_lanes(sp.num_symbols)
    assert nl == SJ.default_num_lanes(sj.num_symbols)
    for lanes in (nl, 32, 512):
        assert_same(ST.grid_row_lane(sp, lanes), SJ.grid_row_lane(sj, lanes), f"nl={lanes}")
    for payload in (0.0, 1e3, 1e5, 1e7):
        for c in (1, 3):
            assert ST.rate_adaptive_lanes(nl, payload, c) == SJ.rate_adaptive_lanes(nl, payload, c)
    v3 = np.arange(18, dtype=np.float32).reshape(3, 6)
    assert_same(sp.expand_params(v3), sj.expand_params(v3))
    with pytest.raises(ValueError):
        ST.get_schedule(h, w, mode="diagonal")


@pytest.mark.parametrize("mode", ST.MODES)
@pytest.mark.parametrize("h,w", MODE_SHAPES)
def test_step_schedules_lane_steps_and_perms_match(h, w, mode):
    """Every mode's schedule (parity's Kahn layering included), its decode
    steps at three lane counts and the stream permutation at C = 1 and 3;
    the geometry they are built from, with the parity-mode fields."""
    assert_same(GT.get_geometry(h, w), GJ.get_geometry(h, w))
    sp, sj = ST.get_schedule(h, w, mode=mode), SJ.get_schedule(h, w, mode=mode)
    assert_same(sp, sj)
    for nl in sorted({16, 32, ST.default_num_lanes(sp.num_symbols)}):
        assert_same(ST.get_lane_steps(h, w, nl, mode=mode), SJ.get_lane_steps(h, w, nl, mode=mode),
                    f"nl={nl}")
        for c in (1, 3):
            assert_same(ST.get_stream_perm(h, w, nl, mode=mode, channels=c),
                        SJ.get_stream_perm(h, w, nl, mode=mode, channels=c), f"nl={nl} C={c}")


@pytest.mark.parametrize("seed", range(3))
def test_layer_waves_matches(seed):
    """The numpy longest-path layering on random DAGs (edges from lower to
    higher node ids, some repeated, some absent) against the JAX package's."""
    rng = np.random.default_rng(seed)
    n = 400
    deps = np.full((n, 3), -1, dtype=np.int64)
    for i in range(1, n):
        k = rng.integers(0, 4)
        deps[i, :k] = rng.integers(max(0, i - 40), i, size=k)
    assert_same(ST._layer_waves(n, deps), SJ._layer_waves(n, deps))
    with pytest.raises(AssertionError):
        ST._layer_waves(2, np.array([[1, -1, -1], [0, -1, -1]]))


@pytest.mark.parametrize("h,w", SHAPES)
def test_lattice_grids_and_wave_plans_match(h, w):
    """The lattice grids (bases, occupancy, slots, tap shifts, parent
    polyphase maps, scale-2 fixups), and the port's wave table (built from
    the schedule's wave sizes) against frave_tpu's wave constants (built
    from its lattice wave plans): each wave's symbol count, rows and live
    lanes, and its schedule slots against frave_tpu's wslot."""
    lp, lj = LT.get_lattice_grids(h, w), LJ.get_lattice_grids(h, w)
    assert_same(lp, lj)
    geo, sched = GT.get_geometry(h, w), ST.get_schedule(h, w, mode="grid")
    nl = ST.default_num_lanes(sched.num_symbols)
    waves = GDT.grid_waves(geo, sched, nl, "cpu")
    waves_j = GDJ.get_wave_devs(GJ.get_geometry(h, w), SJ.get_schedule(h, w, mode="grid"), nl,
                                geo.num_tiles * geo.nodes_per_tile)
    assert len(waves) == len(waves_j)
    for i, (wd, wj, k0) in enumerate(zip(waves, waves_j, GDT.wave_starts(waves))):
        assert (wd.kw, wd.rows) == (wj.kw, wj.rows), i
        np.testing.assert_array_equal(wd.active_rows.numpy(), np.asarray(wj.active_rows),
                                      err_msg=str(i))
        np.testing.assert_array_equal(sched.sched_coef[k0:k0 + wd.kw], np.asarray(wj.wslot),
                                      err_msg=str(i))


@pytest.mark.parametrize("h,w,dense_expected", [(16, 16, False), (31, 17, False), (32, 32, False),
                                                (2, 511, True), (64, 64, True), (96, 80, True)])
def test_grid_waves_exactly_where_frave_tpu_has_dense_grids(h, w, dense_expected):
    """A grid program decodes by waves exactly where frave_tpu builds its
    dense wave constants (a 2-pixel strip among them), and through kernel
    D's step tensors where frave_tpu's get_wave_devs raises
    DenseGridUnavailable (tiny shapes, 32x32 among them)."""
    sched = ST.get_schedule(h, w, mode="grid")
    nl = ST.default_num_lanes(sched.num_symbols)
    geo = GJ.get_geometry(h, w)
    try:
        GDJ.get_wave_devs(geo, SJ.get_schedule(h, w, mode="grid"), nl,
                          geo.num_tiles * geo.nodes_per_tile)
        dense = True
    except LJ.DenseGridUnavailable:
        dense = False
    assert dense == dense_expected
    prog = PT.CodecProgram.from_host(h, w, nl, 1, "cpu")
    assert (prog.waves is not None) == dense
    assert (prog.steps is None) == dense
    if not dense:
        with pytest.raises(LT.DenseGridUnavailable):
            GDT.grid_waves(GT.get_geometry(h, w), sched, nl, "cpu")


@pytest.mark.parametrize("seed", range(3))
def test_host_context_tables_match(seed):
    """The Laplace grid constants and the host tables from histograms
    (encode side) and from wire fields (decode side)."""
    for name in ("ALPHABET_SIZE", "CONTEXT_AMOUNT", "MIN_FREQ_BITS", "MAX_FREQ_BITS_CAP",
                 "ENC_FREQ_BITS_CAP", "NUM_SCALES", "BUCKET_EDGES", "GRID_WIDTHS",
                 "_LAPLACE_GRID_ROWS", "_GRID_LOG2"):
        assert_same(getattr(HT, name), getattr(HJ, name), name)
    rng = np.random.default_rng(seed)
    for k in range(20):
        kind = k % 4
        hist = np.zeros(HT.ALPHABET_SIZE, dtype=np.int64)
        if kind == 1:
            hist[0] = rng.integers(1, 5000)
        elif kind == 2:
            s = np.minimum(rng.geometric(0.3, 3000) - 1, HT.ALPHABET_SIZE - 1)
            hist = np.bincount(s, minlength=HT.ALPHABET_SIZE)
        elif kind == 3:
            hist = rng.integers(0, 40, HT.ALPHABET_SIZE)
        bucket = int(rng.integers(0, HT.CONTEXT_AMOUNT))
        tp = HT.context_from_histogram(hist, bucket)
        assert_same(tp, HJ.context_from_histogram(hist, bucket))
        bits = int(rng.integers(8, 15))
        assert HT.select_scale(hist, bits) == HJ.select_scale(hist, bits)
        off = tp.off_distribution_values.tolist()
        assert_same(
            HT.context_from_wire(bucket, tp.max_freq_bits, off, tp.scale_idx),
            HJ.context_from_wire(bucket, tp.max_freq_bits, off, tp.scale_idx),
        )


@pytest.mark.parametrize("h,w", SHAPES)
def test_choose_transform_matches(h, w):
    px = natural_image(h, w, 3, seed=h + w)
    px[: h // 4, : w // 4, 0] = 255  # saturated chroma, where the mod-256 wraps cost
    for policy in ("none", "auto", "subtract-green", "ycocg"):
        for lossless in (True, False):
            if policy == "ycocg" and not lossless:
                with pytest.raises(ValueError):
                    CTT.choose_transform(px, policy, lossless)
                continue
            assert CTT.choose_transform(px, policy, lossless) == CTJ.choose_transform(
                px, policy, lossless
            ), (policy, lossless)
    for t in (0, 1, 2, 3):
        np.testing.assert_array_equal(CTT._FORWARD[t](px), CTJ._FORWARD[t](px))


def test_options_match():
    for q in OT.EncoderQuality:
        assert_same(OT.quantization_matrix(q), OJ.quantization_matrix(OJ.EncoderQuality[q.name]))
    vp = np.arange(36, dtype=np.float32).reshape(6, 6)
    for wp in (None, vp + 1):
        for c in (1, 3):
            assert_same(
                OT.EncoderOptions(value_prediction_params=vp,
                                  width_prediction_params=wp).prediction_overrides(c),
                OJ.EncoderOptions(value_prediction_params=vp,
                                  width_prediction_params=wp).prediction_overrides(c),
            )


@pytest.mark.parametrize(
    "name", ["v7_gray", "v7_rgb", "v8_gray", "v8_rgb", "v9grid_gray", "v9grid_rgb"]
)
def test_golden_fixture_container_round_trip(name):
    """The port parses each golden fixture to the same fields as
    frave_tpu and writes back frave_tpu's bytes: the fixture itself for
    v9 (both containers write v9, so a v7/v8 fixture comes back as the
    v9 container of the same image)."""
    blob = open(os.path.join(DATA, f"{name}.frv"), "rb").read()
    cp, cj = CT.deserialize(blob), CJ.deserialize(blob)
    assert_same(cp, cj)
    out = CT.serialize(cp)
    assert out == CJ.serialize(CJ.deserialize(blob))
    if name.startswith("v9"):
        assert out == blob


def test_reference_hashes_match_a_fresh_jax_encode():
    """The 256x256 gray entry of tests/data/torch_port_refs.json, encoded
    anew by frave_tpu's jax backend (tests/make_torch_refs.py)."""
    from make_torch_refs import reference_entry

    refs = json.load(open(os.path.join(DATA, "torch_port_refs.json")))
    assert refs["backend"] == "jax"
    entry = next(e for e in refs["entries"]
                 if (e["label"], e["quality"]) == ("256x256 gray", "LOSSLESS"))
    assert reference_entry("256x256 gray", "LOSSLESS") == entry
