"""Top-level host PyTorch ops per frame: aten ops nested in no other host
event of their thread (the harness's spans aside)."""


def read(trace):
    frames = trace.units("frame")
    if not frames:
        return None
    return trace.top_level_host_ops() / frames
