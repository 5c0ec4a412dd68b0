"""Generic matrix over ring elements (+ Strassen multiplication).

Counterpart of `openfhe_tpu/math/matrix.py`, a copy (reference analog:
matrix.h, Matrix<Element>: Ones/Identity/Fill/GadgetVector/Norm/Mult/Add/
Sub/Transpose/Determinant/CofactorMatrix/VStack/HStack/ExtractRow(s)/
ExtractCol, and matrixstrassen*). A Python container: elements need only
+, -, * (numbers, Field2n, RingPoly), each of which keeps its own tensor
on its own device; a `zero` allocator supplies additive identities,
matching the reference's alloc_func. It backs the trapdoor and GPV
machinery (`lattice/trapdoor.py`, `lattice/dgsampling.py`).
"""

from __future__ import annotations

import math


class Matrix:
    """(reference Matrix<Element>, matrix.h:66)"""

    def __init__(self, alloc_zero, rows: int, cols: int, alloc_gen=None):
        self.alloc_zero = alloc_zero
        self.rows = rows
        self.cols = cols
        gen = alloc_gen or alloc_zero
        self.data = [[gen() for _ in range(cols)] for _ in range(rows)]

    # -- element access ----------------------------------------------------
    def __call__(self, row: int, col: int):
        return self.data[row][col]

    def set(self, row: int, col: int, value) -> "Matrix":
        self.data[row][col] = value
        return self

    def GetRows(self) -> int:
        return self.rows

    def GetCols(self) -> int:
        return self.cols

    # -- fills -------------------------------------------------------------
    def Fill(self, val) -> "Matrix":
        for r in range(self.rows):
            for c in range(self.cols):
                self.data[r][c] = val
        return self

    def Ones(self) -> "Matrix":
        one = self.alloc_zero()
        return self.Fill(one + 1 if not hasattr(one, "ones_like")
                         else one.ones_like())

    def Identity(self) -> "Matrix":
        zero = self.alloc_zero()
        for r in range(self.rows):
            for c in range(self.cols):
                if r == c:
                    self.data[r][c] = (zero + 1 if not hasattr(
                        zero, "ones_like") else zero.ones_like())
                else:
                    self.data[r][c] = self.alloc_zero()
        return self

    def GadgetVector(self, base: int = 2) -> "Matrix":
        """Powers-of-base gadget g = [1, b, b^2, ...] per block row
        (reference matrix.h:230)."""
        k = self.cols // self.rows
        g = Matrix(self.alloc_zero, self.rows, self.cols)
        g.data[0][0] = self.alloc_zero() + 1
        for i in range(1, k):
            g.data[0][i] = g.data[0][i - 1] * base
        for row in range(1, self.rows):
            for i in range(k):
                g.data[row][i + row * k] = g.data[0][i]
        return g

    # -- arithmetic --------------------------------------------------------
    def Add(self, other: "Matrix") -> "Matrix":
        assert self.rows == other.rows and self.cols == other.cols
        out = Matrix(self.alloc_zero, self.rows, self.cols)
        for r in range(self.rows):
            for c in range(self.cols):
                out.data[r][c] = self.data[r][c] + other.data[r][c]
        return out

    def Sub(self, other: "Matrix") -> "Matrix":
        assert self.rows == other.rows and self.cols == other.cols
        out = Matrix(self.alloc_zero, self.rows, self.cols)
        for r in range(self.rows):
            for c in range(self.cols):
                out.data[r][c] = self.data[r][c] - other.data[r][c]
        return out

    def Mult(self, other: "Matrix") -> "Matrix":
        assert self.cols == other.rows, "inner dimensions must match"
        out = Matrix(self.alloc_zero, self.rows, other.cols)
        for r in range(self.rows):
            for c in range(other.cols):
                acc = self.alloc_zero()
                for i in range(self.cols):
                    acc = acc + self.data[r][i] * other.data[i][c]
                out.data[r][c] = acc
        return out

    def StrassenMult(self, other: "Matrix", leaf: int = 2) -> "Matrix":
        """Strassen's 7-multiplication recursion for square power-of-two
        matrices (reference matrixstrassen*); falls back to Mult at the
        leaf size or non-conforming shapes."""
        n = self.rows
        if (n != self.cols or other.rows != other.cols or n != other.rows
                or n & (n - 1) or n <= leaf):
            return self.Mult(other)
        h = n // 2

        def q(mat, ri, ci):
            out = Matrix(mat.alloc_zero, h, h)
            for r in range(h):
                for c in range(h):
                    out.data[r][c] = mat.data[ri * h + r][ci * h + c]
            return out

        a11, a12, a21, a22 = q(self, 0, 0), q(self, 0, 1), q(self, 1, 0), \
            q(self, 1, 1)
        b11, b12, b21, b22 = q(other, 0, 0), q(other, 0, 1), q(other, 1, 0), \
            q(other, 1, 1)
        m1 = a11.Add(a22).StrassenMult(b11.Add(b22), leaf)
        m2 = a21.Add(a22).StrassenMult(b11, leaf)
        m3 = a11.StrassenMult(b12.Sub(b22), leaf)
        m4 = a22.StrassenMult(b21.Sub(b11), leaf)
        m5 = a11.Add(a12).StrassenMult(b22, leaf)
        m6 = a21.Sub(a11).StrassenMult(b11.Add(b12), leaf)
        m7 = a12.Sub(a22).StrassenMult(b21.Add(b22), leaf)
        c11 = m1.Add(m4).Sub(m5).Add(m7)
        c12 = m3.Add(m5)
        c21 = m2.Add(m4)
        c22 = m1.Sub(m2).Add(m3).Add(m6)
        out = Matrix(self.alloc_zero, n, n)
        for r in range(h):
            for c in range(h):
                out.data[r][c] = c11.data[r][c]
                out.data[r][c + h] = c12.data[r][c]
                out.data[r + h][c] = c21.data[r][c]
                out.data[r + h][c + h] = c22.data[r][c]
        return out

    def ScalarMult(self, scalar) -> "Matrix":
        out = Matrix(self.alloc_zero, self.rows, self.cols)
        for r in range(self.rows):
            for c in range(self.cols):
                out.data[r][c] = self.data[r][c] * scalar
        return out

    def __add__(self, other):
        return self.Add(other)

    def __sub__(self, other):
        return self.Sub(other)

    def __mul__(self, other):
        if isinstance(other, Matrix):
            return self.Mult(other)
        return self.ScalarMult(other)

    def __eq__(self, other):
        if not isinstance(other, Matrix) or self.rows != other.rows \
                or self.cols != other.cols:
            return False
        for r in range(self.rows):
            for c in range(self.cols):
                eq = self.data[r][c] == other.data[r][c]
                if hasattr(eq, "all"):
                    eq = bool(eq.all())
                if not eq:
                    return False
        return True

    # -- structure ---------------------------------------------------------
    def Transpose(self) -> "Matrix":
        out = Matrix(self.alloc_zero, self.cols, self.rows)
        for r in range(self.rows):
            for c in range(self.cols):
                out.data[c][r] = self.data[r][c]
        return out

    def Determinant(self):
        """Cofactor-expansion determinant (reference matrix.h:533; used for
        small Field2n matrices in SampleMat)."""
        assert self.rows == self.cols
        n = self.rows
        if n == 1:
            return self.data[0][0]
        if n == 2:
            return (self.data[0][0] * self.data[1][1]
                    - self.data[0][1] * self.data[1][0])
        det = self.alloc_zero()
        for c in range(n):
            minor = self._minor(0, c)
            term = self.data[0][c] * minor.Determinant()
            det = det + term if c % 2 == 0 else det - term
        return det

    def _minor(self, row: int, col: int) -> "Matrix":
        out = Matrix(self.alloc_zero, self.rows - 1, self.cols - 1)
        rr = 0
        for r in range(self.rows):
            if r == row:
                continue
            cc = 0
            for c in range(self.cols):
                if c == col:
                    continue
                out.data[rr][cc] = self.data[r][c]
                cc += 1
            rr += 1
        return out

    def CofactorMatrix(self) -> "Matrix":
        out = Matrix(self.alloc_zero, self.rows, self.cols)
        for r in range(self.rows):
            for c in range(self.cols):
                minor = self._minor(r, c).Determinant()
                out.data[r][c] = minor if (r + c) % 2 == 0 else \
                    self.alloc_zero() - minor
        return out

    def VStack(self, other: "Matrix") -> "Matrix":
        assert self.cols == other.cols
        out = Matrix(self.alloc_zero, self.rows + other.rows, self.cols)
        out.data = [row[:] for row in self.data] + \
                   [row[:] for row in other.data]
        return out

    def HStack(self, other: "Matrix") -> "Matrix":
        assert self.rows == other.rows
        out = Matrix(self.alloc_zero, self.rows, self.cols + other.cols)
        out.data = [a[:] + b[:] for a, b in zip(self.data, other.data)]
        return out

    def ExtractRow(self, row: int) -> "Matrix":
        out = Matrix(self.alloc_zero, 1, self.cols)
        out.data = [self.data[row][:]]
        return out

    def ExtractRows(self, start: int, end: int) -> "Matrix":
        out = Matrix(self.alloc_zero, end - start + 1, self.cols)
        out.data = [self.data[r][:] for r in range(start, end + 1)]
        return out

    def ExtractCol(self, col: int) -> "Matrix":
        out = Matrix(self.alloc_zero, self.rows, 1)
        out.data = [[self.data[r][col]] for r in range(self.rows)]
        return out

    def Norm(self) -> float:
        """Max of element norms (reference matrix.h:296); elements expose
        Norm() or are numbers."""
        best = 0.0
        for row in self.data:
            for v in row:
                best = max(best, v.Norm() if hasattr(v, "Norm")
                           else abs(float(v)))
        return best

    def SetFormat(self, fmt) -> "Matrix":
        self.data = [[v.SetFormat(fmt) if hasattr(v, "SetFormat") else v
                      for v in row] for row in self.data]
        return self

    def apply(self, fn) -> "Matrix":
        out = Matrix(self.alloc_zero, self.rows, self.cols)
        for r in range(self.rows):
            for c in range(self.cols):
                out.data[r][c] = fn(self.data[r][c])
        return out
