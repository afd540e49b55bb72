"""setup_library_s: the seconds the port took to load its kernel library,
a build included where the span's key is ``build`` (``load`` where the
library was there): the set-up span ``setup.library`` of the program's
record (utils/profiling.py::SETUP_SPANS).
Nothing where the run loaded no library, or the program keeps no record.
The record is read in the process that prints the result line: a cell on
several cards would read its parent process's, which is empty."""


def read(t):
    from critic_vae_tpu_torch.utils import profiling

    spans = [s for s in getattr(profiling, "SETUP_SPANS", ())
             if s.name == "setup.library" and s.end_ns is not None]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9
