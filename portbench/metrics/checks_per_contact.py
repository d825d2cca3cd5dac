"""Leaf tests per contact or hit: the tile engine's ``num_checks`` (the
tests of live bands) over the pairs found, summed over the traced run's
steps.  Useful work against attempts."""


def read(tr):
    pairs = [(c, t) for c, t in zip(tr.checks, tr.totals)
             if c is not None and t > 0]
    if not pairs:
        return None
    return sum(c for c, _ in pairs) / sum(t for _, t in pairs)
