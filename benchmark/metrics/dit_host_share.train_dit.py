"""dit_host_share.train_dit: the share of the traced steps' host time in
``train.forward_backward`` spent inside the DiT's forward, in %: 100 × Σ
(``dit.embed`` + ``dit.blocks`` + ``dit.final``) ÷ Σ ``train.forward_backward``.
The rest is the backward's dispatch by autograd and the loss. Read only where
every traced step ran one forward of the whole net: as many ``dit.blocks``
spans as traced steps, each with ``blocks`` equal to the configuration's
depth."""

from benchmark.spans import named, total_ns, trees

NAME = "dit_host_share.train_dit"


def read(record):
    spans = trees(record, NAME, "train.step")
    if spans is None:
        return None
    blocks, depth = named(spans, "dit.blocks"), int(record.cell.config["net"]["depth"])
    want = record.counts.get("traced_steps")
    if len(blocks) != want or any(s.attrs.get("blocks") != depth for s in blocks):
        record.note(f"{NAME} left out: {len(blocks)} dit.blocks spans ({[s.attrs.get('blocks') for s in blocks]} "
                    f"blocks), {want} steps of {depth} blocks profiled")
        return None
    whole = total_ns(spans, "train.forward_backward")
    if whole <= 0:
        return None
    return 100.0 * total_ns(spans, "dit.embed", "dit.blocks", "dit.final") / whole
