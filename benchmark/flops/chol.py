"""Operations and bytes of one batched Cholesky sweep (``cholesky_rt``):
B n^3 / 3 multiply-adds, the upper triangle of each A read once (in its
own precision) and the factor R's triangle written once in float32."""


def sweep(batch: int, n: int, in_bytes: int) -> tuple:
    tri = n * (n + 1) // 2
    return 2.0 * batch * n ** 3 / 3.0, float(batch * tri * (in_bytes + 4))
