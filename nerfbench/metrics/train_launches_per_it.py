"""train_launches_per_it: device operations (kernels, copies, fills) per
iteration of the profiled span."""


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    return tr["span"]["launches"] / tr["units"]
