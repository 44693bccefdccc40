"""Training of the port: the optimizer and schedules, the text trainer and
the guided sampler's base-LM (TinyGPT) trainer."""
