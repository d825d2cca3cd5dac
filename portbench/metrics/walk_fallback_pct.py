"""Share of public traverse calls that end in the leaf-vs-tree walk after
eight tile runs: 100 times the program's ``grow.walks`` counter over
``calls.traverse``, over the whole process."""

from portbench import spans


def read(tr):
    share = spans.per_call("grow.walks")
    return None if share is None else 100.0 * share
