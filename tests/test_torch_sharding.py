"""Port parity: the sharding rules and the serve cells' specs
(``repro_torch.distributed.sharding``, ``repro_torch.launch.specs``,
``repro_torch.launch.mesh``) against the reference, in this process, with
no rank started.

The reference's ``PartitionSpec`` s are translated to the port's DTensor
placements (one ``Shard(i)`` / ``Replicate()`` per mesh dimension, in mesh
order) and held equal, each side called with the same abstract mesh: an
ordered ``{axis: size}`` for the port, a stand-in with ``axis_names`` /
``shape`` (or a JAX ``AbstractMesh`` where the reference builds
``NamedSharding`` s) for the reference. Parameter and cache shapes come
from the reference's ``jax.eval_shape`` and the port's meta tensors, so
full-size configs cost no memory.
"""
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.launch.mesh import parse_mesh_spec as ref_parse  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import (make_serve_mesh,  # noqa: E402
                                     parse_mesh_spec)
from repro_torch.models.model import Model  # noqa: E402

MESHES = {"data=4": {"data": 4}, "data=2,model=4": {"data": 2, "model": 4},
          "pod=2,data=2": {"pod": 2, "data": 2}}


class _FakeMesh:
    """Duck-typed mesh: the reference's spec(mesh=) / _fit only need
    axis_names + shape."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


def placements(pspec, axes: dict) -> tuple:
    """A reference PartitionSpec as the port's placements on ``axes``."""
    out = [Replicate()] * len(axes)
    for i, part in enumerate(pspec):
        for a in (() if part is None else
                  part if isinstance(part, tuple) else (part,)):
            if a in axes:
                out[list(axes).index(a)] = Shard(i)
    return tuple(out)


def _flat(tree, prefix=()):
    """{key path: leaf} over nested dicts (the port's trees)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _ref_flat(tree):
    """{key path: leaf} of a reference pytree whose leaves are
    PartitionSpecs / NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or hasattr(x, "spec"))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            getattr(v, "spec", v) for path, v in leaves}


def _same_specs(ref_tree, port_tree, axes):
    ref, port = _ref_flat(ref_tree), _flat(port_tree)
    assert set(ref) == set(port)
    for k, sp in ref.items():
        got = port[k]
        got = getattr(got, "placements", got)
        assert got == placements(sp, axes), (k, sp, got)


def test_rules_equal_the_reference():
    assert SH.RULES == RSH.RULES


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("logical, shape", [
    (("batch", None), (8, 16)), (("batch", None), (6, 16)),
    (("batch", "kv_seq", None, None), (8, 64, 8, 32)),
    (("batch", None, "kv_heads", None), (8, 64, 8, 32)),
    (("heads", "fsdp"), (16, 12)), (("vocab", "fsdp"), (49152, 576)),
    (("experts", None, "fsdp"), (64, 16, 8)), ((None, "ffn"), (4, 6)),
    (("none", "seq_sp"), (3, 8)), (("batch", None), None)])
def test_spec_equals_the_reference(mesh, logical, shape):
    axes = MESHES[mesh]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RSH.spec(*logical, shape=shape, mesh=_FakeMesh(**axes))
        got = SH.spec(*logical, shape=shape, mesh=axes)
    assert got == placements(want, axes)
    assert SH.spec(*logical, shape=shape) == ()          # no mesh


def test_spec_refuses_one_mesh_axis_on_two_dims():
    """Where two dims' rules name one mesh axis the reference builds a
    PartitionSpec no mesh accepts; the port refuses it at once."""
    with pytest.raises(ValueError, match="'model' is used by two dims"):
        SH.spec("batch", "kv_seq", "kv_heads", None, shape=(8, 64, 8, 32),
                mesh={"data": 2, "model": 4})


def _drops(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn()
    return [str(x.message) for x in w
            if x.category.__name__ == "ShardingDropWarning"]


def test_spec_drop_warning_text_and_once():
    """The drop warning's text is the reference's, on the multi-axis
    product rule and a single axis; a repeat is silent, another dim warns
    again, and no shape given opts out of fitting."""
    RSH._WARNED_DROPS.clear()
    SH._WARNED_DROPS.clear()
    pod = {"pod": 2, "data": 2}
    texts = []
    for logical, shape, axes in ((("batch", None), (6, 16), pod),
                                 (("kv_heads",), (8,), {"model": 16})):
        want = _drops(lambda: RSH.spec(*logical, shape=shape,
                                       mesh=_FakeMesh(**axes)))
        got = _drops(lambda: SH.spec(*logical, shape=shape, mesh=axes))
        assert len(got) == 1 and got == want
        assert _drops(lambda: SH.spec(*logical, shape=shape,
                                      mesh=axes)) == []
        texts += got
    assert re.search(r"'batch' .*dim 6 .*extent 4 of pod\+data "
                     r"\(product of present axes\)", texts[0])
    assert "'kv_heads'" in texts[1] and "REPLICATED" in texts[1]
    assert len(_drops(lambda: SH.spec("batch", None, shape=(10, 16),
                                      mesh=pod))) == 1
    assert _drops(lambda: SH.spec("batch", None, mesh=pod)) == []


def test_shard_places_nothing_and_checks_the_rule():
    SH._WARNED_DROPS.clear()
    x = torch.zeros(6, 4)
    assert SH.shard(x, "batch", None) is x             # no ambient mesh
    with SH.set_mesh({"data": 4}):
        assert SH.get_abstract_mesh() == {"data": 4}
        assert SH.mesh_axis_size("data") == 4
        assert SH.mesh_axis_size("model") == 1
        assert len(_drops(lambda: SH.shard(x, "batch", None))) == 1
    assert SH.get_abstract_mesh() is None


def _ref_pshape(cfg):
    return jax.eval_shape(lambda: RefModel(cfg).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ["smollm_135m", "moonshot_v1_16b_a3b"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_equal_the_reference(arch, fsdp, monkeypatch):
    """``param_specs`` on the reduced arch's params (its serving config's:
    ``qw`` / ``sg`` leaves) equals the reference's under the same mesh,
    row- and column-parallel linears, experts and norms alike."""
    from repro.launch.specs import serve_config as ref_serve
    from repro_torch.launch.specs import param_shapes, serve_config
    axes = {"data": 2, "model": 4}
    monkeypatch.setattr(RSH, "_ambient_mesh", lambda: _FakeMesh(**axes))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RSH.param_specs(_ref_pshape(ref_serve(ref_reduced(arch))),
                               fsdp=fsdp)
        pshape = param_shapes(Model(serve_config(get_reduced(arch)),
                                    device="meta"))
        got = SH.param_specs(pshape, fsdp=fsdp, mesh=axes)
    _same_specs(want, got, axes)


CELL_ARCHS = ["smollm-135m", "recurrentgemma-9b", "xlstm-125m",
              "whisper-tiny"]


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_cell_specs_equal_the_reference(arch, monkeypatch):
    """``cache_specs`` (inside ``serve_cell_specs``: the KV, recurrent and
    mLSTM ``C`` / ``n`` leaves), ``serve_cell_specs`` and
    ``prefill_cell_specs`` of the published config on the production
    layout (2 x 16 x 16) equal the reference's; the port's stand-ins are
    meta tensors of the reference's shapes."""
    axes = {"pod": 2, "data": 16, "model": 16}
    mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    shape = SHAPES["decode_32k"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RS.serve_cell_specs(ref_cfg, REF_SHAPES["decode_32k"], mesh)
        got = S.serve_cell_specs(cfg, shape, axes)
    _, r_pshape, r_cshape, r_tok, r_psp, r_csp, r_tsp = want
    _, pshape, cshape, tok, psp, csp, tsp = got
    assert all(a.device.type == "meta" for a in _flat(cshape).values())
    for path, leaf in _ref_flat(r_cshape).items():
        assert tuple(_flat(cshape)[path].shape) == tuple(leaf.shape), path
    _same_specs(r_psp, psp, axes)       # no ambient mesh: replicated
    _same_specs(r_csp, csp, axes)
    # the params' rules at full size under the mesh, the serve-fsdp
    # decision included
    fsdp = S._serve_fsdp(pshape, axes)
    assert fsdp == RS._serve_fsdp(r_pshape, mesh)
    monkeypatch.setattr(RSH, "_ambient_mesh", lambda: mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_specs(RSH.param_specs(r_pshape, fsdp=fsdp),
                    SH.param_specs(pshape, fsdp=fsdp, mesh=axes), axes)
    monkeypatch.undo()
    assert tsp.placements == placements(r_tsp.spec, axes)
    assert tuple(tok.shape) == tuple(r_tok.shape)
    # the caches' rule alone, on a data-only mesh as well
    for m in ({"data": 4}, axes):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = RS.cache_specs(ref_cfg, r_cshape, _FakeMesh(**m))
            g = S.cache_specs(cfg, cshape, m)
        _same_specs(r, g, m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RS.prefill_cell_specs(ref_cfg, REF_SHAPES["prefill_32k"],
                                     mesh)
        got = S.prefill_cell_specs(cfg, SHAPES["prefill_32k"], axes)
    assert got[3] == want[3]
    assert {k: tuple(v.shape) for k, v in got[2].items()} == {
        k: tuple(v.shape) for k, v in want[2].items()}
    _same_specs(want[4], got[4], axes)
    _same_specs(want[5], got[5], axes)


def test_parse_mesh_spec_equals_the_reference():
    for good in ("data=4", "pod=2,data=2", " data = 2 ,model=4"):
        assert parse_mesh_spec(good) == ref_parse(good)
    for bad in ("data", "data=", "data=0", "=4", "data=4,data=2", "data=x"):
        with pytest.raises(ValueError) as want:
            ref_parse(bad)
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(bad)
        assert str(got.value) == str(want.value)


def test_make_serve_mesh_needs_ranks():
    """With no process group a mesh is refused, naming the ranks it needs
    and how to start them (the reference names XLA_FLAGS)."""
    with pytest.raises(ValueError, match="needs 4 ranks but the process "
                       "group has 0.*run_ranks"):
        make_serve_mesh("data=4", device="cpu")


def test_mesh_decode_report_line():
    """The reference's line, ranks where it says devices."""
    rline = RS.mesh_decode_report(
        jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                          ("data", "model")), 4, 8, 2.0)
    line = S.mesh_decode_report({"data": 4}, 8, 16, 3.2)
    assert line == ("[mesh] data=4 (4 ranks) | 2 batch rows/rank | 8x16 "
                    "tokens in 3.20s (200.0 ms/token wall incl. prefill)")
    assert rline.startswith("[mesh] data=1,model=1 (1 devices) | no data "
                            "axes > 1 | 4x8 tokens in 2.00s (250.0 ms/token")
    assert S.mesh_decode_report({"data": 1, "model": 1}, 4, 8, 2.0) \
        .startswith("[mesh] data=1,model=1 (1 ranks) | no data axes > 1 | "
                    "4x8 tokens in 2.00s (250.0 ms/token")
    assert "batch 6 REPLICATED (4 does not divide it)" in \
        S.mesh_decode_report({"pod": 2, "data": 2}, 6, 1, 1.0)


def test_mesh_serve_report_line():
    """The engine's line: the slots are the rows split over the ranks, and
    the requests and tokens are those served."""
    line = S.mesh_serve_report({"data": 2}, 4, 8, 256, 70, 7.0)
    assert line == ("[mesh] data=2 (2 ranks) | 2 slot rows/rank | 8 "
                    "requests, 256 tokens in 7.00s (27.3 ms/token wall incl. "
                    "prefill; 70 packed decode steps, 100.0 ms/step)")
    assert "slot 3 REPLICATED (2 does not divide it)" in \
        S.mesh_serve_report({"data": 2}, 3, 8, 256, 70, 7.0)
