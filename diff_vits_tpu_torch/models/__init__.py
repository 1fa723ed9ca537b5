"""Model assemblies of the port: prior, duration, diffusion decoder."""
