"""Port parity: the paper's evaluation (``repro_torch.core.patterns``,
``transitive``, ``transitive_ref``, ``energy``, ``costmodel``,
``workloads`` and ``repro_torch.paper``) against the JAX package's numpy
modules and its ``benchmarks/`` sections, on the same seeded numpy
inputs.

Integers are held equal exactly; the cost models' floats within rtol
1e-12 (the same numpy arithmetic in the same order: they come out equal);
each paper section's CSV rows equal row for row, the timing column of
the ``*_total`` rows aside. The reference's own claims
(``tests/test_costmodel.py``, the ``tile_stats`` tests of
``tests/test_scoreboard.py``, ``tests/test_transitive_lossless.py``) are
repeated on the port.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from _compat import given, settings, strategies as st  # noqa: E402
from repro.core import costmodel as ref_cm  # noqa: E402
from repro.core import energy as ref_energy  # noqa: E402
from repro.core import patterns as ref_patterns  # noqa: E402
from repro.core import scoreboard as ref_sb  # noqa: E402
from repro.core import transitive as ref_transitive  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core import patterns, transitive, transitive_ref  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.core.scoreboard import (dynamic_scoreboard,  # noqa: E402
                                         static_scoreboard,
                                         static_tile_stats)
from repro_torch.paper import run as paper_run  # noqa: E402

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
RTOL = 1e-12


def _rows(seed, tiles=4, n=64, t=8):
    return np.random.default_rng(seed).integers(
        0, 1 << t, size=(tiles, n)).astype(np.uint32)


# -- patterns.tile_stats ------------------------------------------------------

@pytest.mark.parametrize("t", [2, 4, 8, 10])
@pytest.mark.parametrize("n", [16, 256])
def test_tile_stats_equal_reference(t, n):
    """Every TileStats field and property equal, exactly."""
    rows = _rows(100 + t, tiles=6, n=n, t=t)
    want = ref_patterns.tile_stats(ref_sb.dynamic_scoreboard(rows, t))
    got = patterns.tile_stats(dynamic_scoreboard(rows, t))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    for prop in ("density", "density_ppe", "bit_density", "cycles"):
        np.testing.assert_array_equal(getattr(got, prop),
                                      getattr(want, prop), err_msg=prop)


def test_paper_fig1_example():
    """Fig. 1: rows {1011,1111,0011,0010} need 4 ops vs 10 bit-sparse."""
    st_ = patterns.tile_stats(dynamic_scoreboard(
        np.array([[0b1011, 0b1111, 0b0011, 0b0010]]), 4))
    assert st_.ppe_ops[0] == 4
    assert st_.bit_ops[0] == 10
    assert st_.tr[0] == 0


def test_density_bounds_random_t8():
    """Sec. 5.2: runtime density ~1/T at N=256; PPE density below it;
    bit density ~0.5; distances: none >= 4 at N=256."""
    st_ = patterns.tile_stats(dynamic_scoreboard(_rows(1, tiles=32, n=256),
                                                 8))
    d = st_.density.mean()
    assert 0.118 < d < 0.135, d
    assert (st_.density_ppe < st_.density + 1e-9).all()
    assert abs(st_.bit_density.mean() - 0.5) < 0.02
    assert st_.dist_hist[:, 4].sum() == 0


def test_zero_rows_skipped():
    st_ = patterns.tile_stats(dynamic_scoreboard(np.zeros((1, 16),
                                                          np.uint32), 8))
    assert st_.ppe_ops[0] == 0 and st_.ape_ops[0] == 0
    assert st_.zr[0] == 16


def test_static_vs_dynamic_density_crossover():
    """Fig. 13: static SI matches dynamic at large tile rows, degrades at
    small tile rows (SI misses)."""
    rng = np.random.default_rng(3)
    all_rows = rng.integers(0, 256, size=(1 << 14,)).astype(np.uint32)
    ssi = static_scoreboard(all_rows, 8)

    def density(tile_rows):
        tiles = all_rows.reshape(-1, tile_rows)[:16]
        s = static_tile_stats(ssi, tiles)
        return (np.maximum(s["ppe"], s["ape"]) / s["dense"]).mean()

    d64, d1024 = density(64), density(1024)
    dyn64 = patterns.tile_stats(dynamic_scoreboard(
        all_rows.reshape(-1, 64)[:16], 8)).density.mean()
    assert d64 > dyn64
    assert d1024 < d64 * 0.75


# -- transitive GEMM and its oracle --------------------------------------------

CASES = [(2, 4, 5, 3, 4), (4, 8, 9, 2, 6), (8, 8, 6, 3, 5), (4, 4, 12, 4, 3),
         (8, 10, 4, 2, 3)]          # (bits, t, n, k tiles, m)


def _operands(bits, t, n, kt, m, seed=0):
    rng = np.random.default_rng(seed + 31 * bits + t)
    w = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, kt * t))
    x = rng.integers(-128, 128, size=(kt * t, m))
    return w, x, w.astype(np.int64) @ x.astype(np.int64)


@pytest.mark.parametrize("bits, t, n, kt, m", CASES)
def test_transitive_gemm_equal_reference(bits, t, n, kt, m):
    w, x, want = _operands(bits, t, n, kt, m)
    got = transitive.transitive_gemm(w, x, bits, t)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref_transitive.transitive_gemm(w, x, bits, t))


@pytest.mark.parametrize("bits, t, n, kt, m", CASES)
def test_transitive_gemm_ref_equal_reference(bits, t, n, kt, m):
    w, x, want = _operands(bits, t, n, kt, m, seed=1)
    got = transitive_ref.transitive_gemm_ref(w, x, bits, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref_transitive.transitive_gemm_ref(w, x, bits, t))
    # the public module re-exports the oracle, as the reference's does
    assert transitive.transitive_gemm_ref is transitive_ref.transitive_gemm_ref


@pytest.mark.parametrize("t, max_distance", [(4, 4), (8, 4), (8, 2)])
def test_execute_tile_equal_reference(t, max_distance):
    """The psum table of every tile of a batch, equal to the reference's
    walker on the reference's scoreboard; every executed node's psum is
    the sum of its bits' input rows."""
    rows = _rows(7 + t, tiles=3, n=48, t=t)
    x = np.random.default_rng(t).integers(-128, 128, size=(t, 5))
    si = dynamic_scoreboard(rows, t, max_distance)
    rsi = ref_sb.dynamic_scoreboard(rows, t, max_distance)
    bits = (np.arange(1 << t)[:, None] >> np.arange(t)) & 1
    for tile in range(3):
        got = transitive.execute_tile(si, tile, x)
        np.testing.assert_array_equal(
            got, ref_transitive.execute_tile(rsi, tile, x))
        done = si.exec_counts[tile] > 0
        np.testing.assert_array_equal(got[done], (bits @ x)[done])


@pytest.mark.parametrize("bits, t", [(4, 8), (8, 8), (2, 4)])
def test_transitive_gemm_stats_equal_reference(bits, t):
    w, x, want = _operands(bits, t, 24, 4, 3, seed=2)
    got, totals = transitive.transitive_gemm_stats(w, x, bits, t)
    rgot, rtotals = ref_transitive.transitive_gemm_stats(w, x, bits, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgot)
    assert totals == rtotals


@given(bits=st.sampled_from([2, 4, 8]), t=st.sampled_from([4, 8]),
       n=st.integers(1, 20), kt=st.integers(1, 5), m=st.integers(1, 9),
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=40, deadline=None)
def test_lossless_random(bits, t, n, kt, m, seed):
    rng = np.random.default_rng(seed)
    k = kt * t
    w = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, k))
    x = rng.integers(-128, 128, size=(k, m))
    np.testing.assert_array_equal(transitive.transitive_gemm(w, x, bits, t),
                                  w.astype(np.int64) @ x.astype(np.int64))


@given(fill=st.sampled_from([-8, -1, 0, 1, 7]), seed=st.integers(0, 99))
@settings(max_examples=15, deadline=None)
def test_lossless_degenerate(fill, seed):
    rng = np.random.default_rng(seed)
    w = np.full((7, 16), fill)
    x = rng.integers(-128, 128, size=(16, 3))
    np.testing.assert_array_equal(transitive.transitive_gemm(w, x, 4, 8),
                                  w.astype(np.int64) @ x.astype(np.int64))


def test_lossless_duplicate_heavy(rng):
    """FR-dominated tiles (few unique patterns) stay exact."""
    pats = rng.integers(-8, 8, size=(3, 16))
    w = pats[rng.integers(0, 3, size=64)]
    x = rng.integers(-128, 128, size=(16, 5))
    got, totals = transitive.transitive_gemm_stats(w, x, 4, 8)
    np.testing.assert_array_equal(got, w.astype(np.int64) @ x.astype(np.int64))
    assert totals["density"] < 0.30


def test_stats_density_sane(rng):
    w = rng.integers(-128, 128, size=(64, 64))
    x = rng.integers(-128, 128, size=(64, 4))
    got, totals = transitive.transitive_gemm_stats(w, x, 8, 8)
    np.testing.assert_array_equal(got, w.astype(np.int64) @ x.astype(np.int64))
    assert 1 / 8 - 0.02 <= totals["density"] <= 0.75
    assert totals["bit_ops"] <= totals["dense_ops"]


# -- energy, workloads and the cost models -------------------------------------

def test_energy_constants_equal_reference():
    names = [n for n in vars(ref_energy) if n.isupper()]
    assert len(names) > 20
    for name in names:
        assert getattr(energy, name) == getattr(ref_energy, name), name
    a = energy.EnergyTally(1.0, 2.0, 3.0, 4.0)
    b = ref_energy.EnergyTally(1.0, 2.0, 3.0, 4.0)
    assert (a + a).total == (b + b).total == 20.0


def _gemm_tuples(gemms):
    return [(g.n, g.k, g.m, g.w_bits, g.a_bits, g.name, g.macs,
             g.dram_bytes) for g in gemms]


@pytest.mark.parametrize("model", sorted(ref_workloads.LLAMA_DIMS))
def test_workloads_equal_reference(model):
    assert workloads.LLAMA_DIMS == ref_workloads.LLAMA_DIMS
    for kw in ({}, {"w_bits": 4}, {"w_bits": 4, "a_bits": 4},
               {"seq": 512}):
        assert _gemm_tuples(workloads.llama_fc_gemms(model, **kw)) == \
            _gemm_tuples(ref_workloads.llama_fc_gemms(model, **kw))
    for kw in ({}, {"bits": 16}, {"seq": 128}):
        assert _gemm_tuples(workloads.llama_attention_gemms(model, **kw)) \
            == _gemm_tuples(ref_workloads.llama_attention_gemms(model, **kw))


def test_resnet_workload_equal_reference():
    for kw in ({}, {"w_bits": 8}, {"w_bits": 2, "a_bits": 4}):
        assert _gemm_tuples(workloads.resnet18_gemms(**kw)) == \
            _gemm_tuples(ref_workloads.resnet18_gemms(**kw))


def _close(a, b, what):
    assert a == pytest.approx(b, rel=RTOL, abs=0), what


def _profile_equal(got, want):
    for f in ("ppe_cycles", "ape_cycles", "ppe_ops", "ape_ops", "n_rows",
              "cycles"):
        _close(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("w_bits, t, n_rows, max_tiles", [
    (8, 8, 256, 64), (4, 8, 256, 64), (4, 8, 128, 16), (8, 4, 64, 32)])
def test_sample_subtile_stats_equal_reference(w_bits, t, n_rows, max_tiles):
    from repro_torch.paper.common import synth_weights
    w = synth_weights(256, 256, w_bits, seed=w_bits)
    _profile_equal(
        cm.sample_subtile_stats(w, w_bits, t, n_rows, max_tiles, seed=3),
        ref_cm.sample_subtile_stats(w, w_bits, t, n_rows, max_tiles,
                                    seed=3))


@pytest.mark.parametrize("w_bits", [4, 8])
def test_random_subtile_profile_equal_reference(w_bits):
    _profile_equal(cm.random_subtile_profile(w_bits, tiles=32, seed=5),
                   ref_cm.random_subtile_profile(w_bits, tiles=32, seed=5))


def _run_equal(got, want):
    assert got.name == want.name
    _close(got.cycles, want.cycles, "cycles")
    _close(got.seconds, want.seconds, "seconds")
    for part in ("pe", "buffer", "dram", "static", "total"):
        _close(getattr(got.energy, part), getattr(want.energy, part), part)


WORKLOADS = {
    "fc8": lambda W: W.llama_fc_gemms("llama1-7b", w_bits=8),
    "fc4": lambda W: W.llama_fc_gemms("llama3-8b", w_bits=4),
    "fc44": lambda W: W.llama_fc_gemms("llama2-13b", w_bits=4, a_bits=4),
    "attention": lambda W: W.llama_attention_gemms("llama1-7b", seq=256),
    "resnet": lambda W: W.resnet18_gemms(),
}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("name", ["bitfusion", "ant", "olive", "tender",
                                  "bitvert", "transarray"])
def test_cost_models_equal_reference(name, workload):
    """Every model's RunResult (cycles, seconds, each energy part) and
    every GEMM's, within rtol 1e-12."""
    if name == "transarray":
        prof = cm.random_subtile_profile(4, tiles=32)
        rprof = ref_cm.random_subtile_profile(4, tiles=32)
        model = cm.TransitiveArrayModel(prof, 4)
        ref = ref_cm.TransitiveArrayModel(rprof, 4)
    else:
        model, ref = cm.BASELINES[name](), ref_cm.BASELINES[name]()
    gemms = WORKLOADS[workload](workloads)
    ref_gemms = WORKLOADS[workload](ref_workloads)
    _run_equal(model.run(gemms), ref.run(ref_gemms))
    for g, rg in zip(gemms, ref_gemms):
        _run_equal(model.run_gemm(g), ref.run_gemm(rg))
        assert model.tile_nm() == ref.tile_nm()


def test_core_area_equal_reference():
    got, want = cm.core_area_mm2(), ref_cm.core_area_mm2()
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], k)
    assert cm.DRAM_GBPS == ref_cm.DRAM_GBPS
    assert sorted(cm.BASELINES) == sorted(ref_cm.BASELINES)


def test_area_matches_paper_table2():
    areas = cm.core_area_mm2()
    want = {"transarray": 0.443, "bitfusion": 0.491, "ant": 0.484,
            "olive": 0.490, "bitvert": 0.473, "tender": 0.474}
    for k, v in want.items():
        assert abs(areas[k] - v) < 0.01, (k, areas[k], v)
    assert areas["transarray"] == min(areas.values())


@pytest.fixture(scope="module")
def runs():
    g8 = workloads.llama_fc_gemms("llama1-7b", w_bits=8)
    g4 = workloads.llama_fc_gemms("llama1-7b", w_bits=4)
    return {
        "ta8": cm.TransitiveArrayModel(cm.random_subtile_profile(8), 8).run(g8),
        "ta4": cm.TransitiveArrayModel(cm.random_subtile_profile(4), 4).run(g4),
        "ant": cm.AntModel().run(g8),
        "olive": cm.OliveModel().run(g8),
        "bitvert": cm.BitVertModel().run(g8),
        "bitfusion": cm.BitFusionModel().run(g8),
    }


def test_iso_precision_speedups(runs):
    """Paper Sec. 5.5: TA-8b ~2.47x ANT, ~3.75x Olive, ~1.99x BitVert."""
    assert 1.7 < runs["ta8"].speedup_over(runs["ant"]) < 3.3
    assert 2.6 < runs["ta8"].speedup_over(runs["olive"]) < 5.0
    assert 1.3 < runs["ta8"].speedup_over(runs["bitvert"]) < 2.7


def test_iso_accuracy_speedups(runs):
    """Paper: TA-4b ~4.91x ANT, ~7.46x Olive, ~3.97x BitVert."""
    assert 3.4 < runs["ta4"].speedup_over(runs["ant"]) < 6.5
    assert 5.2 < runs["ta4"].speedup_over(runs["olive"]) < 9.5
    assert 2.6 < runs["ta4"].speedup_over(runs["bitvert"]) < 5.2


def test_energy_direction(runs):
    for k in ("ant", "olive", "bitfusion"):
        assert runs[k].energy.total > runs["ta4"].energy.total, k


def test_buffer_dominates_ta_breakdown(runs):
    e = runs["ta4"].energy
    assert e.buffer > e.pe and e.buffer > e.dram


def test_attention_speedup_positive(runs):
    att = workloads.llama_attention_gemms("llama1-7b")
    ta = cm.TransitiveArrayModel(cm.random_subtile_profile(8), 8).run(att)
    s_att = ta.speedup_over(cm.AntModel().run(att))
    assert 1.0 <= s_att <= runs["ta8"].speedup_over(runs["ant"]) * 1.35


def test_profile_matches_paper_stats():
    p = cm.random_subtile_profile(8)
    assert 150 < p.ppe_ops < 180
    assert 250 < p.ape_ops <= 256
    assert p.cycles >= 32


# -- the paper harness -----------------------------------------------------------

SECTIONS = ["dse", "fc", "energy_area", "attention", "scoreboard", "resnet"]


def _rows_of(text):
    """CSV rows with the timing column of ``*_total`` rows blanked."""
    out = []
    for row in text.splitlines():
        name, us, derived = row.split(",", 2)
        out.append((name, "" if name.endswith("_total") else us, derived))
    return out


@pytest.mark.parametrize("section", SECTIONS)
def test_paper_section_rows_equal_reference(section, capsys):
    import importlib
    sys.path.insert(0, ROOT)
    try:
        ref = importlib.import_module(f"benchmarks.bench_{section}")
    finally:
        sys.path.remove(ROOT)
    ref.run()
    want = _rows_of(capsys.readouterr().out)
    paper_run.SECTIONS[section]()
    got = _rows_of(capsys.readouterr().out)
    assert len(got) > 1 and got[-1][0].endswith("_total")
    assert got == want


def test_run_prints_header_rows_and_total(capsys):
    paper_run.main(["resnet"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in lines[1:]] == [
        "fig14_resnet18", "fig14_total", "all"]
    assert lines[-1].endswith("sections=['resnet']")


@pytest.mark.parametrize("section, item", [("kernel", "A4"),
                                           ("roofline", "A10.3")])
def test_run_refuses_sections_not_ported(section, item, capsys):
    with pytest.raises(SystemExit, match=f"item {item}") as e:
        paper_run.main(["resnet", section])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""        # nothing ran
    with pytest.raises(SystemExit, match="unknown section"):
        paper_run.main(["fig99"])
