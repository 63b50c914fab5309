"""The reference networks, one module an arch name, each with
`build(conf, max_offset_y)`."""
