"""Hand-written Hopper kernels of the port and their plain versions.

``transitive_forest`` (the ``engine_cuda`` forest) and ``paged_attention``
(live-page decode attention). Sources are in ``repro_torch/csrc``; they
are compiled by :mod:`repro_torch.kernels.build` at first use.
"""
