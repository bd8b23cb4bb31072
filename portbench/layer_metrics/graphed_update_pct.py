"""Share of the process's collection member updates whose device work ran
as a replay of the collection's captured graph: 100 x the port's
``_stats.member_update_counts()["replay"]`` over all member updates
(replayed, capturing and eager), set-up and every stretch included.

Reads nothing where the program has no such counter (an older checkout)
or counted no member update."""


def read(trace):
    from torcheval_tpu_torch import _stats

    counts = getattr(_stats, "member_update_counts", None)
    if counts is None:
        return None
    by_how = counts()
    total = sum(by_how.values())
    if not total:
        return None
    return 100.0 * by_how.get("replay", 0) / total
