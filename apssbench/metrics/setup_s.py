"""Seconds from the process's start to the window's: imports, the card's
context, the inputs drawn on the device, the port's set-up (kernel
libraries built or loaded, the index), and the warm-up of the cell's own
shapes."""


def read(run):
    return run.setup_s
