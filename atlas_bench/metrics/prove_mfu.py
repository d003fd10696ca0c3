"""prove_mfu: the field work a proof needs (work.proof_imads, from the
shapes the frozen verifier read) over the mean prove's seconds times
the card's IMAD peak, in %."""


def read(r):
    pk = r["peak"]
    if pk is None or not r["imads_per_proof"] or not r["prove_s"]:
        return None
    return 100.0 * r["imads_per_proof"] / (r["prove_s"] * pk["imad_per_s"])
