from . import analysis, gr, timer, tools  # noqa: F401
