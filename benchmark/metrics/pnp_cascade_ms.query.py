"""Device ms per query inside both ransac_pnp calls, match_cascade and
count_pose_inliers, by CUDA events."""
from harness import readers


def read(r):
    return readers.span_ms(r, "query", "pnp_cascade")
