"""The streamed ScaNN build's pass 3 (s): quantizing the rows and
scattering them into the leaves. The build runs before the traced
window, so this reads the program's own phase records:
`scann.build.scatter` of the last build in this process, synchronized
with the card at the pass's end. Nothing to read where the program keeps
no such record."""

from recommenders_tpu_torch.utils import profiling

NAME = "scann.build.scatter"


def read(reading):
    if reading is None:
        return None
    records = getattr(profiling, "phases", lambda: [])()
    seconds = [p.seconds for p in records if p.name == NAME]
    return seconds[-1] if seconds else None
