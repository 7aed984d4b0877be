"""Rounds of the four QP solves of one call (smoothing, post-smoothing and
both path-QP passes; a round is ``qp_check_every`` ADMM iterations): the
device tallies of the timed key, read once before and once after the traced
window, over the window's calls."""


def read(traced: dict):
    return traced.get("qp_rounds")
