"""The least work of the step and of each kernel: bytes each input is read
once and each output written once, at its stored width, and the dense
layers' operations.  Counted from what the inputs need, not from the
padded work the program does, so no share of a peak can pass 100%.  The
step's count is the configuration's reference's (``step.py``: ``pcgnn.py``,
``gcn.py``); each kernel's is the module of its name."""
