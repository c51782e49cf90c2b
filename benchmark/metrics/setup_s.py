"""setup_s: host seconds from the process's first line to the window's
first request: imports, kernel libraries loaded (built in a checkout's
first run), weights drawn, engine built, warm requests served through every
KV bucket (capturing each bucket's CUDA graph)."""


def read(run):
    return run.setup_s
