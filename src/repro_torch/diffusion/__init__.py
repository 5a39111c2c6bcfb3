"""Diffusion substrate: U-Net, DDIM schedules, batch-denoising executor."""
