"""Set-up seconds: from the harness's start, once the interpreter has
loaded torch, to the window's opening (the port's import, a checkout's
first library build, the card's context, the seeded inputs, the warm-up
over the cell's shapes, the pipeline's construction)."""


def read(run):
    return run.setup_s
