"""Hand-written Hopper kernels of the port and their plain versions.

``transitive_forest`` (the ``engine_cuda`` forest), ``paged_attention``
(live-page decode attention), ``transitive_gemm`` (the doubling-LUT GEMM
of the ``lut_cuda`` backend), ``w4a8_gemm`` (group-dequant GEMM) and
``rg_lru`` (linear recurrence). Sources are in ``repro_torch/csrc``; they
are compiled by :mod:`repro_torch.kernels.build` at first use. The plain
versions of the last three are in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` is the public API over all of them.
"""
