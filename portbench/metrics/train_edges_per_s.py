"""Candidate edges of every epoch completed in the window over the whole
window, validations included; an epoch's edges are the pick's expectation
(``reference.graph.edges_per_epoch``)."""


def read(rec):
    w = rec["window"]
    return w["epochs"] * w["edges_per_epoch"] / w["seconds"]
