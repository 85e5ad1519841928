"""Device classify pass: PyTorch counterparts of desamba_tpu/engine/device."""
