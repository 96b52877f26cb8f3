"""setup_s: seconds from the start of ``run.py`` to the first measured
call (imports, weights, frames, the program's build, kernel builds where
the checkout has none yet, warm-up), host clock."""


def read(rec):
    return rec.setup_s
