"""Set-up: from the process's start to the window's (imports, the CUDA
context, the capture made on the card, the program compiled and warmed)."""


def read(run):
    return run.setup_s
