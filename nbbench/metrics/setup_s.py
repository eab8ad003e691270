"""setup_s: seconds from the harness's first line to the window's start:
imports, the CUDA context, the kernel library (built only by a checkout's
first run), traffic generation, the warm-up engine, the engine and its load."""


def read(obs):
    return obs.setup_s
