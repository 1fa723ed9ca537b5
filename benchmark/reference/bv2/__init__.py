"""The plain reference of bv2 (``bv2.py`` of github.com/adelacvg/diff-vits,
"big VITS 2"): the frozen reference's VITS with the UNet duration
predictor and the residual spec flow, plus the phoneme-level prosody VAE.

The VAE (``model.PhonemeVAE``, state dict ``vits.phoneme_vae.*`` as the
port's ``models/phoneme_vae.py``): at inference, after the spec flow has
reversed the prior sample z_p, the phoneme prior over the text
(``ph_enc_p``: Linear, four pre-LN ``EncSALayer``, Linear -> m, logs) is
sampled as m + noise * exp(logs) * noise_scale, the noise one standard
normal [B, Tx, inter] drawn after the prior's; the phoneme flow
(``phoneme_flow``) runs in reverse over the text mask; the result is
expanded to frames by the alignment and added to z_p before ``o_proj``.
In training the frame latent is mean-pooled into phonemes along the MAS
path, sampled by the posterior (``ph_encoder_q``), its KL taken against
the prior through the flow, and its expansion added to the latent.

Float32 plain ``torch``; every layer but the VAE's is the frozen
reference's, and so are ``synthesize``, ``Vocos`` and ``maximum_path``.
Its work count is ``work``. Departures from ``bv2.py``:

* the weights are random from a seed (the harness's), not trained;
* the duration predictor is the UNet one, which ``bv2.py`` builds with
  the prompt (``benchmark/configs/bv2.json`` notes it under
  ``assumed``); other predictors are refused;
* no VAE warm-up: the prosody and its KL count from the first step, as
  in the port (``phoneme_vae_warmup_steps`` is read by nothing);
* the training loss's ``loss/kl`` holds the frame KL plus the phoneme KL,
  so that ``loss/all`` is the port's 40 diff + len + kl + kl_ph;
* the phoneme KL is divided by the whole batch's text tokens, so that a
  batch run a block of rows at a time adds up to the whole batch's.
"""
from benchmark.reference.bv2 import work
from benchmark.reference.bv2.model import DiffVits
from benchmark.reference.config import Config
from benchmark.reference.layers import maximum_path
from benchmark.reference.model import synthesize
from benchmark.reference.vocos import Vocos

__all__ = ["Config", "DiffVits", "synthesize", "Vocos", "maximum_path",
           "work"]
