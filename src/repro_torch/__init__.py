"""PyTorch + CUDA port of the Transitive Array serving path.

A second package beside the JAX reference ``repro``: same module names,
same parameter layout, same integer results. It imports ``torch`` and
numpy only. Entry points (:class:`~repro_torch.models.model.Model`,
:class:`~repro_torch.serve.engine.ServeEngine`, ``launch.serve``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no CUDA device
and no explicit CPU request they raise (:func:`resolve_device`).

The hand-written Hopper kernels live in ``kernels/`` (wrappers) and
``csrc/`` (CUDA C++ sources, built with ``nvcc`` at first use); the two
of the forest serving path:

  * ``transitive_forest`` — the Scoreboard forest from a compact
    ``ForestPlan`` (backend ``engine_cuda``);
  * ``paged_attention`` — live-page decode attention over the int8 pool.

On CPU tensors each wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
