"""Convolutions new to the process per 1000 steps of the timed window:
the port's ``conv_new_shapes`` counter (on the card in cuDNN's benchmark
mode, each one a timing of cuDNN's algorithms inside a step)."""


def read(rec):
    c = rec.counters
    if c is None or "conv_new_shapes" not in c or not rec.steps:
        return None
    return 1e3 * c["conv_new_shapes"] / rec.steps
