"""The plain references that decide ``correct``, in plain PyTorch and
NumPy, float32 with TF32 off.  They import nothing of the program and work
out again, from the generator's raw arrays, everything the program
derives: the CSR of each graph the model reads, the keep counts, the
window cap, the splits, the pick weights and the selections.

A configuration names its reference by the module's name under
``reference`` in its file (``pcgnn`` when the key is absent); the harness
and the check reach it only through these functions of the module:

* ``build_graph(raw, cfg, device)``: the reference graph of the
  configuration ``cfg`` from the generator's arrays ``raw``, with
  ``features``, ``labels``, ``relations``, ``idx_train``, ``idx_valid``,
  ``train_pos``, ``sample_size``, ``permutation`` and ``to(device)``.
  ``relations`` are the graphs the model reads, each with ``deg`` and
  ``dcap`` (the harness sums their degrees and takes their window widths
  for the counts): PC-GNN's relations, or for a model of the homo graph
  (GCN, GraphSAGE) the homo graph as the one relation.
  ``sample_size`` is the plan's real slots an epoch; ``permutation``
  True says the plan takes every training node once (``sample_size`` is
  then the training split's size), False that it draws them (PC-GNN's
  pick); ``check.pick_bad`` holds the plan to the rule it states;
* ``edges_per_epoch(g)``: the candidate edges an epoch brings;
* ``initial_weights(seed, raw, cfg, device)``: the model's initial
  weights, in the program's parameter names, drawn on ``device``;
* ``steps(g, params0, batches, weights, hyper, low)``: the training
  steps from ``params0`` (the losses, the first step's gradient as Adam
  takes it, the parameters after the last step); ``low``: the control;
* ``fraud_probabilities(g, params, nodes, hyper, low)``: the fraud
  probability of each of ``nodes``.

A reference's step count, which ``step_mfu`` reads, is the module of the
same name under ``counts/``.

``pcgnn`` is PC-GNN's one Pick-Choose-Aggregate layer, its joint loss, its
gradients and Adam; ``graph`` its graph, ``weights`` its initial weights.
``gcn`` is the GCN baseline over the homo graph, ``sage`` the GraphSAGE
baseline over it.  ``plain`` holds what they share: the control's TF32,
the gathered rows' sums, cross-entropy and Adam.

A new configuration brings new files and entries alone: its
configuration file under ``configs/`` and each cell's traffic file under
``workloads/``, a reference module here and a count module under
``counts/`` of one name where no reference it could name exists yet, and
its entries in ``BENCHMARK.json`` (the configuration, each cell, and the
cell's name in the ``workloads`` list of each per-layer metric it reads).
The benchmark's tests read its cells, their CPU cuts and their metric
lists from those files.
"""
