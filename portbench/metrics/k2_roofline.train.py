"""k2_roofline.train: the least time the card could take for the K2
work the window's steps need (portbench/kernels/flash_attention.bound)
over the traced device time of the flash_attention class's kernels."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train_lm" or t is None:
        return None
    spent = t.by_class.get("flash_attention", 0.0)
    need = r["classes"]["flash_attention"].bound(r["work"])
    if not spent or need is None:
        return None
    return 100.0 * need / spent
