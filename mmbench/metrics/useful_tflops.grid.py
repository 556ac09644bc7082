"""Useful TFLOP/s (``useful_tflops``) of the grid cells: the whole
product's count over rank 0's window, with a bound of its own."""
from mmbench.metrics import reader

read = reader("useful_tflops")
