"""setup_s: seconds from process start to the first timed job (library
load, inputs made from the seed, the program's state built, the warm-up
job)."""


def read(win):
    return win.setup_s
