"""Port parity: checkpoints. The port's ``distributed/checkpoint.py``
writes the reference's format (``step_%08d/`` with ``manifest.json``,
``::``-joined keys, dtype strings, one ``.npy`` a leaf, the ``latest``
marker), so a checkpoint either package writes restores in the other,
bit for bit: a train state of reduced smollm (bf16 params, f32 moments,
int32 counters). A bf16 leaf is stored as its raw bits and read back
through torch, with ``ml_dtypes`` unimportable. A partial write stays
invisible, the manager keeps the newest ``keep``, and an async save
holds the values of the moment it was called.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.distributed import checkpoint as RC  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed import checkpoint as C  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import train_step as PT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def states():
    """(reference train state, port train state with other values):
    reduced smollm, bf16 params, the same tree."""
    ref_cfg = ref_reduced("smollm_135m").replace(n_layers=2)
    cfg = get_reduced("smollm_135m").replace(n_layers=2)
    ref_model = RefModel(ref_cfg)
    opt = RT.make_optimizer(ref_cfg)
    ref = RT.init_state(ref_model, opt, jax.random.PRNGKey(0))
    ref["opt"]["m"] = jax.tree.map(lambda a: a + 0.25, ref["opt"]["m"])
    ref["opt"]["count"] = jnp.int32(3)
    ref["step"] = jnp.int32(3)
    model = Model(cfg, device="cpu")
    port = PT.init_state(model, PT.make_optimizer(cfg), seed=1)
    return ref, port


def _ref_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _same_bits(port_tree, ref_tree):
    got, want = leaves(port_tree), _ref_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(g), w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_port_restores_a_reference_checkpoint(states, tmp_path):
    ref, port = states
    RC.save(str(tmp_path), 12, ref)
    assert C.latest_step(str(tmp_path)) == 12
    got = C.restore(str(tmp_path), 12, port)
    assert got["params"]["embed"].dtype == torch.bfloat16
    _same_bits(got, ref)


def test_reference_restores_a_port_checkpoint(states, tmp_path):
    ref, port = states
    C.save(str(tmp_path), 7, port)
    assert RC.latest_step(str(tmp_path)) == 7
    got = RC.restore(str(tmp_path), 7, jax.eval_shape(lambda: ref))
    _same_bits(port, got)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = f.read()
    assert '"params::embed"' in manifest and '"bfloat16"' in manifest


def test_bf16_round_trips_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported (the card's
    machine need not have it), a bf16 leaf saves and restores bit for
    bit."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.distributed import checkpoint as C\n"
        "t = torch.randn(5, 7).to(torch.bfloat16)\n"
        f"C.save({str(tmp_path)!r}, 1, {{'w': t, 'n': torch.arange(3)}})\n"
        f"r = C.restore({str(tmp_path)!r}, 1, {{'w': torch.zeros(5, 7, "
        "dtype=torch.bfloat16), 'n': torch.zeros(3, dtype=torch.int64)})\n"
        "assert torch.equal(r['w'].view(torch.int16), t.view(torch.int16))\n"
        "assert r['w'].dtype == torch.bfloat16\n"
        "assert 'ml_dtypes' not in sys.modules or "
        "sys.modules['ml_dtypes'] is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _tree(v):
    return {"params": {"w": torch.full((4, 3), float(v)),
                       "b": torch.arange(5, dtype=torch.int32)},
            "step": torch.tensor(v, dtype=torch.int32)}


def test_partial_write_stays_invisible(tmp_path):
    os.makedirs(tmp_path / ".tmp-step_00000099")
    assert C.latest_step(str(tmp_path)) is None
    C.save(str(tmp_path), 7, _tree(7))
    assert C.latest_step(str(tmp_path)) == 7
    os.makedirs(tmp_path / ".tmp-step_00000008")
    assert C.latest_step(str(tmp_path)) == 7


def test_manager_keeps_the_newest_and_restores_latest(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s))
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000020", "step_00000030"]
    restored, step = mgr.restore_latest(_tree(0))
    assert step == 30 and int(restored["step"]) == 30
    assert torch.equal(restored["params"]["w"], _tree(30)["params"]["w"])


def test_async_save_holds_the_values_at_the_call(tmp_path):
    """The leaves are copied to the host before the write's thread starts:
    updating the tensors in place right after ``save`` (as the next train
    step does) does not reach the checkpoint."""
    mgr = C.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree(5)
    mgr.save(5, tree)
    tree["params"]["w"].add_(100.0)
    tree["step"].add_(1)
    mgr.wait()
    restored, step = mgr.restore_latest(_tree(0))
    assert step == 5 and int(restored["step"]) == 5
    assert torch.equal(restored["params"]["w"], _tree(5)["params"]["w"])
