"""Reference-line smoothing: 1 m segmentation, the TENSION2 smoothing QP and
the Frenet post-smoothing QP over the DP corridor."""
