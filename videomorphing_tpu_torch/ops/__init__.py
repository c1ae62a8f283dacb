"""Array primitives: sampling, windows, pyramids, SSIM statistics, Poisson."""
