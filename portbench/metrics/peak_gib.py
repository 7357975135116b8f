"""peak_gib: torch.cuda.max_memory_allocated over the whole run (set-up
included; the reference runs after it is read), in GiB."""


def read(rec):
    peak = rec.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
