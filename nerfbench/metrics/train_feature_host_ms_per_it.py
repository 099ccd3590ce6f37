"""train_feature_host_ms_per_it: host milliseconds per profiled iteration in the
program's ``field.feature`` spans inside a branch of the step (``step.*``):
the feature head's work in the field query (the learnable PE map's sample
and head, the DINO head on each branch) and in the sky query (the sky
feature head), ``models/fields.py``.  None where the configuration has no
feature head (no such span opens)."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "train", "field.feature", under="step.")
