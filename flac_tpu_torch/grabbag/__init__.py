"""App-toolkit helpers — the port's copy of flac_tpu.grabbag, the analog of
src/share/grabbag: seektable spec parsing, cuesheet text parse/emit, picture
spec parsing with image-header sniffing. Host-side, pure Python."""

from flac_tpu_torch.grabbag.seektable import (  # noqa: F401
    seektable_from_specification,
    seektable_template_sort,
)
from flac_tpu_torch.grabbag.cuesheet import (  # noqa: F401
    CueSheetParseError,
    cuesheet_emit,
    cuesheet_parse,
)
from flac_tpu_torch.grabbag.picture import (  # noqa: F401
    PictureSpecError,
    picture_from_specification,
)
