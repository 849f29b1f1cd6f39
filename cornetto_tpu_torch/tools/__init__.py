"""The port's tools (counterparts of ``cornetto_tpu.tools``): boringbits,
sdust and telofind with their scans on the device, and copies of the host
tools telowin, telobreaks and bigenough."""
