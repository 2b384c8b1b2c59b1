"""Seconds from the process's start to the first timed unit."""


def read(window):
    return window.setup_s
