"""setup_s: seconds from the start of the process to the window's opening."""


def read(run):
    return run.setup_s
