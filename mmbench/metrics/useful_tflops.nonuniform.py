"""Useful TFLOP/s (``useful_tflops``) of the nonuniform cells: their rate swings
more from run to run, so it has a bound of its own."""
from mmbench.metrics import reader

read = reader("useful_tflops")
