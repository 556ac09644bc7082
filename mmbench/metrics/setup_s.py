"""Seconds from the start of the process to the first timed product."""


def read(view):
    return view.setup_s
