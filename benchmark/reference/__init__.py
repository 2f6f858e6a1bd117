"""The plain references that decide `correct`, one module a format.

Each module has `encode(data, level)`, the stock library's writer (the
streams that a read cell's traffic hands the program), `decode(stream)`,
a strict stock reader (one whole stream, every check it carries
verified, nothing after it), and `break_integrity(stream)`, the stream
with the integrity field that the format carries zeroed, for the
control. They import the standard library alone: never the program
(`tpz_torch`), nor JAX or its package.
"""
