"""setup_first_call_s: the seconds of the first call of each of the
port's entry points: the self time of the set-up spans ``setup.first_call``
of the program's record (utils/profiling.py::SETUP_SPANS), each its
duration less the set-up spans it holds directly (the library's load, a
graph capture), summed. That is the call's lazy work (cuDNN's choices,
handles, the allocator's growth, pinned staging, the CRF's plan) and also
one call's steady work: in a video cell the warm-up's first episode whole,
in a training cell one step; the lazy part is this less a steady call. Nothing
where the run opened no such span, or the program keeps no record. The
record is read in the process that prints the result line: a cell on
several cards would read its parent process's, which is empty."""


def read(t):
    from critic_vae_tpu_torch.utils import profiling

    record = list(getattr(profiling, "SETUP_SPANS", ()))
    total, found = 0, False
    for i, s in enumerate(record):
        if s.name != "setup.first_call" or s.end_ns is None:
            continue
        found = True
        total += s.end_ns - s.start_ns
        total -= sum(c.end_ns - c.start_ns for c in record
                     if c.parent == i and c.end_ns is not None)
    return total / 1e9 if found else None
