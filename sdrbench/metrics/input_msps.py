"""Input samples of every dispatch of the window, over the window's wall
time, which ends when its last dispatch has finished on the card."""


def read(run):
    w = run.window
    return w["dispatches"] * run.k * run.frame / w["seconds"] / 1e6
