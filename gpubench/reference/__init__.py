"""The plain reference: what the measured program computes, in plain torch
and float32, from the same inputs, with no import of the program."""
