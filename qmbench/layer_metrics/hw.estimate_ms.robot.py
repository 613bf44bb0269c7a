"""Host ms of the port's `hw.estimate` range (runtime/hw.py: the sensor
read and the IMU estimator) per tick of the traced segment, on the
window's thread alone."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "hw.estimate"), ctx.trace)
