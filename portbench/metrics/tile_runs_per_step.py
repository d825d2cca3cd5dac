"""Fixed-capacity tile runs per public traverse call: the program's
``grow.runs`` counter over ``calls.traverse``, over the whole process (1
when no call regrows)."""

from portbench import spans


def read(tr):
    return spans.per_call("grow.runs")
