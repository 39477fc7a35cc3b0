"""k1_roofline.serve: the least time the card could take for the K1
work the window's requests need (portbench/kernels/paged_attention.bound:
each prompt segment's and each decode step's visible keys and values
read once, their products) over the traced device time of the
paged_attention class's kernels."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve_lm" or t is None:
        return None
    spent = t.by_class.get("paged_attention", 0.0)
    need = r["classes"]["paged_attention"].bound(r["work"])
    if not spent or need is None:
        return None
    return 100.0 * need / spent
