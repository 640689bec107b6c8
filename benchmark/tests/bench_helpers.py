"""What the benchmark's tests share: a cell cut to a size the CPU holds,
and an engine with a fault planted under the timed path."""

import numpy as np


def shrink(spec, hidden, chunk_frames=6, people_mean=3.0, pool_chunks=2, **traffic):
    """`spec` (a resolved cell) at hidden width `hidden`, with small chunks
    of few people; `traffic` overrides further keys of the mix."""
    spec['config']['linear_size'] = hidden
    spec['traffic'].update(chunk_frames=chunk_frames, people_mean=people_mean,
                           pool_chunks=pool_chunks, **traffic)
    return spec


class Broken:
    """`engine` with `fault` planted in what `forward_batch_async`'s
    finalize returns.

    Faults an inference cell can have: a step that hands back what it
    handed before (`stale`: the previous chunk's outputs), half of the
    batch left out (`half`: the second half of a chunk's frames answered
    with zeros), an answer altered where it is produced (`altered`: in
    every frame the first two detections' outputs exchanged; stereo: every
    left pose paired with the next right pose; MC: the epistemic std scaled
    by 1.1). One chip only: no exchange between chips to leave out."""

    FAULTS = ('stale', 'half', 'altered')

    def __init__(self, engine, fault):
        self.engine, self.fault, self.last = engine, fault, None

    def forward_batch_async(self, *args):
        fin = self.engine.forward_batch_async(*args)

        def finalize():
            outs = fin()
            broken = getattr(self, self.fault)(outs)
            self.last = outs
            return broken
        return finalize

    def stale(self, outs):
        return outs if self.last is None else self.last

    @staticmethod
    def half(outs):
        out = list(outs)
        for f in range(len(out) // 2, len(out)):
            out[f] = {k: (tuple(np.zeros_like(t) for t in v) if k == 'yaw' else np.zeros_like(v))
                      for k, v in out[f].items()}
        return out

    @staticmethod
    def altered(outs):
        out = []
        for o in outs:
            o = {k: ((v[0].copy(), v[1].copy()) if k == 'yaw' else np.array(v, copy=True))
                 for k, v in o.items()}
            if len(o['d']) >= 2:
                for k, v in o.items():
                    for arr in (v if k == 'yaw' else (v,)):
                        arr[[0, 1]] = arr[[1, 0]]
            if 'aux_idx' in o:
                o['aux_idx'] = o['aux_idx'] + 1
            o['epi'] = np.asarray(o['epi']) * 1.1
            out.append(o)
        return out
