"""peak_mem_mib (end to end): torch.cuda.max_memory_allocated over the
whole run up to the window's end, set-up and graph pools included; the
largest over the ranks."""


def read(out):
    return out.window.peak_bytes / 2 ** 20
