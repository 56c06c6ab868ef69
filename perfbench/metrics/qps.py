"""qps: queries completed inside the window over the window's seconds."""


def read(run):
    return len(run.window) / run.seconds
