"""Samplers of the port: the reverse-diffusion loop, text sampling and
guided AR + diffusion decoding."""
