"""Auxiliary per-segment index structures (beyond the columnar core).

`ivf`: the IVF ANN coarse quantizer for VECTOR columns, the counterpart
of pinot_tpu/index/ivf.py: k-means centroids trained on the card (K10 /
K11), per-row centroid assignments persisted next to the `.vec.fwd.npy`
block, and the probe-list selection (K9) fused into the filter (K1).
"""
