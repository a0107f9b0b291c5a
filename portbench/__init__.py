"""The benchmark of ``pcgnn_tpu_torch``: PC-GNN and its GCN baseline
training on one card.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: its configuration in ``configs/<config>.json``,
its traffic in ``workloads/<cell>.json``, each metric's reader in
``metrics/<metric>.py`` and the roofline counts in ``counts/``.  The plain
reference that decides ``correct`` is ``reference/``; it imports nothing
of the program.
"""
