"""tokens_per_s: tokens trained (rows x positions x micro-steps) over the
window's wall seconds; each micro-step ends in torch.cuda.synchronize()."""


def read(run):
    return sum(r["tokens"] for r in run.records) / run.window_s
