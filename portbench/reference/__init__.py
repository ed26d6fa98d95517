"""The benchmark's plain reference: plain SIFT and ORB at the
configuration's settings, written from their definitions, which judge a
frontend's keypoints and descriptors (`sift.py`, `orb.py`,
`frontend.py`); ground-truth trajectories from the world's path
arithmetic; Sim(3)-aligned trajectory error (`ate.py`). Nothing here
imports `jax`, the JAX package or the port."""
