"""Live-weight serving fleet (port of ``repro.fleet``): asynchronous
re-planning, hot swap and plan bundles.

Transitive Array's execution plans are functions of the weight
bit-patterns, so every weight update invalidates every plan. This package
keeps serving cells alive through weight churn:

  * :mod:`repro_torch.fleet.replan` — :class:`ReplanWorker` builds new
    plan generations on a background thread (:func:`build_generation`);
    :class:`WeightWatcher` feeds it from a checkpoint directory.
  * :mod:`repro_torch.fleet.bundles` — plan once on a planner, write a
    fingerprinted manifest, attach on any number of servers with zero plan
    builds (:func:`write_bundles` / :func:`load_bundles`).

The hot-swap protocol itself is ``ServeEngine.swap_params``
(``repro_torch/serve/engine.py``).
"""
from repro_torch.fleet.bundles import (MANIFEST, load_bundles, read_manifest,
                                       write_bundles)
from repro_torch.fleet.replan import (Generation, ReplanSuperseded,
                                      ReplanTicket, ReplanWorker,
                                      WeightWatcher, align_device_plans,
                                      build_generation, fingerprint_params)

__all__ = ["Generation", "MANIFEST", "ReplanSuperseded", "ReplanTicket",
           "ReplanWorker", "WeightWatcher", "align_device_plans",
           "build_generation", "fingerprint_params", "load_bundles",
           "read_manifest", "write_bundles"]
