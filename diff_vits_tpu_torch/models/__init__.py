"""Model assemblies of the port: prior, duration, diffusion decoder, and
the Vocos vocoder (mel -> waveform)."""
