"""The GraphSAGE baseline's training step's least work (the ``sage``
reference's count): GCN's (``counts/gcn.py``).  The two steps read and
write the same bytes (the homo windows or, with no store, the neighbors'
rows and ids; the hub rows; the centers; ids, labels and weights; the
parameters and Adam's moments) and make the same products (F x E and
E x C, their weight gradients, the gradient into z).  The mean divides
each row's sum by its count where GCN divides by the count's square root:
B divides in place of B square roots and B divides, no product and no
byte more."""

from portbench.counts.gcn import byte_terms, count, flops  # noqa: F401
