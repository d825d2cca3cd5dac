"""Host syncs per public traverse call: the program's ``syncs`` counter
(each read of a device value on the host, counted at its site) over
``calls.traverse``, over the whole process."""

from portbench import spans


def read(tr):
    return spans.per_call("syncs")
