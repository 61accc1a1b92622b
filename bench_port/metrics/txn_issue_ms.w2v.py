"""Transaction and block step: the dispatcher's host time issuing one
submission's transaction (``SERVER_PROCESS_TRANSACT``: the candidate
gathers, the block step's chunks, both pushes), ms a submission. The work
is stream-ordered, so this is host issue time. Dashboard deltas over the
window."""


def read(ctx):
    txn = ctx.get("txn")
    if not txn or not txn[0]:
        return None
    return txn[1] / txn[0]
