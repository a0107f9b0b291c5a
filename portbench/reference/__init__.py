"""The plain reference that decides ``correct``: PC-GNN's one
Pick-Choose-Aggregate layer, its joint loss, its gradients and Adam, in
plain PyTorch and NumPy, float32 with TF32 off.  It imports nothing of the
program and works out again, from the generator's raw arrays, everything
the program derives: the CSR of each relation, the keep counts, the window
cap, the splits, the pick weights and the selections."""
