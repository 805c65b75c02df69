"""Input records the pipeline consumed over the window's whole time (from
the first chunk until every result of the chunks sent was delivered); a
YSB event counts as one record."""


def read(run):
    return run.records / run.window_s
