"""The paper's analytical evaluation (Figs. 9-14, Table 2) as port
modules: one ``bench_*`` module per figure, each ``run()`` printing
``name,us_per_call,derived`` CSV rows, and ``run`` the entry point:

  PYTHONPATH=src python -m repro_torch.paper.run [section ...]

Every speedup, second, cycle and joule these sections print comes from
``core.costmodel``'s models of the paper's 28 nm accelerators, driven by
scoreboard statistics computed here on the host. None of them is a time
or an energy of the GPU the port runs on, and nothing here touches it.
"""
