"""Training of the port: the optimizer and schedules, and the text trainer."""
