"""The plain references that decide ``correct``, in plain PyTorch and
NumPy, float32 with TF32 off.  They import nothing of the program and work
out again, from the generator's raw arrays, everything the program
derives: the CSR of each relation, the keep counts, the window cap, the
splits, the pick weights and the selections.

A configuration names its reference by the module's name under
``reference`` in its file (``pcgnn`` when the key is absent); the harness
and the check reach it only through these functions of the module:

* ``build_graph(raw, cfg, device)``: the reference graph of the
  configuration ``cfg`` from the generator's arrays ``raw``, with
  ``features``, ``labels``, ``relations`` (each with ``deg`` and
  ``dcap``), ``idx_train``, ``idx_valid``, ``train_pos``, ``sample_size``
  and ``to(device)``;
* ``edges_per_epoch(g)``: the candidate edges an epoch brings;
* ``initial_weights(seed, raw, cfg, device)``: the model's initial
  weights, in the program's parameter names, drawn on ``device``;
* ``steps(g, params0, batches, weights, hyper, low)``: the training
  steps from ``params0`` (the losses, the first step's gradient as Adam
  takes it, the parameters after the last step); ``low``: the control;
* ``fraud_probabilities(g, params, nodes, hyper, low)``: the fraud
  probability of each of ``nodes``.

``pcgnn`` is PC-GNN's one Pick-Choose-Aggregate layer, its joint loss, its
gradients and Adam; ``graph`` its graph, ``weights`` its initial weights.
"""
