"""The card's peak allocation in units of the step's operands (every
rank's send buffers, 4·W·Σn bytes): how many operand-sized sets the
program holds at its peak. The eager path keeps the operands, each
call's fresh result and the result it replaces, so it reads 3; writing
results in place would read 2. Nothing off the card."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / ctx.operand_bytes
