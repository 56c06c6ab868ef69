"""setup_s: seconds from the process's start to the first timed query
(corpus, build, server, warm-up; the first run in a checkout also
compiles the kernels)."""


def read(run):
    return run.setup_s
