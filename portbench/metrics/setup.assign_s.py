"""The streamed ScaNN build's pass 2 (s): the top-R assignment and the
capacity packing. The build runs before the traced window, so this reads
the program's own phase records: `scann.build.assign` of the last build
in this process, synchronized with the card at the pass's end. Nothing
to read where the program keeps no such record."""

from recommenders_tpu_torch.utils import profiling

NAME = "scann.build.assign"


def read(reading):
    if reading is None:
        return None
    records = getattr(profiling, "phases", lambda: [])()
    seconds = [p.seconds for p in records if p.name == NAME]
    return seconds[-1] if seconds else None
