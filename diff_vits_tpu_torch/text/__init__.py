"""Text frontend and symbol tables (copies of the JAX package's)."""
from diff_vits_tpu_torch.text.symbols import (
    symbols,
    num_tones,
    num_languages,
    language_id_map,
    language_tone_start_map,
)
from diff_vits_tpu_torch.text.frontend import (
    cleaned_text_to_sequence, clean_text)
