"""setup_capture_s: the seconds the port spent capturing CUDA graphs, the
set-up spans ``setup.capture`` of the program's record
(utils/profiling.py::SETUP_SPANS: each capture of the train step and of
the saliency stage, once for each signature's shapes), summed. Nothing where the run captured no graph, or
the program keeps no record. The record is read in the process that prints
the result line: a cell on several cards would read its parent process's,
which is empty."""


def read(t):
    from critic_vae_tpu_torch.utils import profiling

    spans = [s for s in getattr(profiling, "SETUP_SPANS", ())
             if s.name == "setup.capture" and s.end_ns is not None]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9
