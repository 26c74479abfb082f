"""The card's peak allocated memory over set-up and the window
(`torch.cuda.max_memory_allocated`, reset at process start), in GiB."""


def read(run):
    return run["peak_bytes"] / 2 ** 30
