"""stop_floor_share: the solves of the traced window that stopped on the
FLOOR rule, over all the solves that stopped (the program's ``stop.*``
counters, one a lane stop, by its status), in %.  A program without those
counters gives nothing."""


def read(run):
    from benchmark import spans
    got = spans.counts(run) or {}
    stops = sum(v for k, v in got.items() if k.startswith("stop."))
    return 100.0 * got.get("stop.floor", 0) / stops if stops else None
