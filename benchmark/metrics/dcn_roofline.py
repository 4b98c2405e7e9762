"""dcn_roofline: the least time the modulated deformable convolutions (K1 band, K2 gather) of the
profiled protocol calls need (`work.protocol_bounds`: flops over the bf16
peak or bytes over the bandwidth, the larger) over the device time of the
kernels that did that work, by name, in percent. Nothing when no such
kernel ran."""
from benchmark.tracing import kernel_seconds
from benchmark.work import protocol_bounds

KERNELS = ("dcn_band_kernel", "dcn_gather_kernel")


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    spent = kernel_seconds(trace, KERNELS)
    if spent <= 0:
        return None
    need = protocol_bounds(record["family"], record["config"]["sizes"], record["mix"])["dcn"]
    return 100.0 * need * record["mix"]["trace_calls"] / spent
