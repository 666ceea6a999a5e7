"""The share of the transformer blocks of the timed window's sparse
forwards that ran on the window chain's masked stale-K/V path, in %: the
port's ``transformer_chain_blocks`` counter over it plus
``transformer_dense_blocks`` (the dense middle and any block off the
chain)."""


def read(rec):
    c = rec.counters
    if not c or "transformer_chain_blocks" not in c:
        return None
    total = c["transformer_chain_blocks"] + c["transformer_dense_blocks"]
    if not total:
        return None
    return 100.0 * c["transformer_chain_blocks"] / total
