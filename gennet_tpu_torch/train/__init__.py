"""Training: CNN point-estimator and pair-GAN steps, checkpoints, metrics."""
