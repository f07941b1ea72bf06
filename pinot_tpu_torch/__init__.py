"""pinot_tpu_torch — the PyTorch/CUDA port of pinot_tpu.

The same OLAP engine (PQL → per-segment plan → one fused device dispatch
→ exact host finishing → combine → broker reduce), with the per-segment
device work done by kernels written by hand for NVIDIA Hopper
(ops/csrc/*.cu). Modules mirror pinot_tpu's layout and names; the package
imports torch and numpy and nothing of JAX or of pinot_tpu.

Entry point: `pinot_tpu_torch.engine.QueryEngine(segments, device=None)`,
which runs on the card unless `device="cpu"` is passed.
"""

__version__ = "0.1.0"
