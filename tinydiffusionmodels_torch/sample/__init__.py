"""Samplers of the port: the reverse-diffusion loop and text sampling."""
