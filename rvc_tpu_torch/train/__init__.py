"""Training: data, losses, optimizers, the GAN step and the trainer (port of ``rvc_tpu/train``)."""
