"""``draft_verify`` (``csrc/draft_verify.cu``: ``verify_greedy`` /
``verify_rows`` / ``verify_split``) against its roofline: the sum over the
traced launches of ``work.verify_work``'s bound at the session's call over
the kernel's device time in the trace, in percent. Only the greedy family
launches it; a beam cell finds nothing to read."""

from perfbench import work

ENTRIES = {
    ("repro_torch.core.session", "draft_verify"): (
        lambda a, kw: (*a[0].shape, a[0].element_size()),
        work.verify_work),
}
KERNELS = r"\bverify_(greedy|rows|split)\b"


def read(run, name):
    return run.roofline(name)
