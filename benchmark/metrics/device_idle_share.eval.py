"""device_idle_share.eval: the share of the profiled protocol calls' window
in which no kernel ran, in percent (the profiler on: an upper bound)."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["count"] == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
