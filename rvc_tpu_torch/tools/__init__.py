"""Measuring tools of the port's kernels, run as modules on a card:
``python3 -m rvc_tpu_torch.tools.mrf_ablation``,
``python3 -m rvc_tpu_torch.tools.kernel_spills``."""
