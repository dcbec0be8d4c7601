"""Model layers of the port: dense MLPs, the VAE, the cost predictor."""
