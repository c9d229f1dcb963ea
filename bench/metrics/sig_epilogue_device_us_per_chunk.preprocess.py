"""Device time launched under the engine's ``sig.epilogue`` spans (the
plain-PyTorch pack after the kernel; 0 where the kernel packs), per
traced engine call (us)."""

from bench.program_spans import split


def read(view):
    parts = split(view)
    return None if parts is None else parts.per_call("sig.epilogue")
