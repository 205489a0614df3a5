"""GENERATED by tools/gen_wall_channels.py — do not edit.

Channel decomposition of the Swan-Brady single-wall
correction (see the generator docstring):
  W(R, h) = -RPY_s2(R).D + sum_m h^m T_m(R),
  T_m = sum over CHANNELS[(m, mon)] of
        coeff * mon * O_op(del) del_z^p {r | 1/r}.
Verified against ops/rpy.py::wall_tt_radii at 40 digits.

The PyTorch port's copy of rigidmultiblobswall_tpu/ops/_wall_channels_gen.py
(the port imports nothing of the JAX package). ops/_emit_wall_cuh.py
reads img_terms from this file to emit csrc/wall_img_terms.cuh.
"""

from fractions import Fraction

# (channel m, radius monomial) -> [(op, base, p, coeff)]
# op in {iso, hess, zrow, zcol, zz}; base 4 -> r (FT -8 pi/k^4), 2 -> 1/r (FT 4 pi/k^2)
CHANNELS = {
    (0, '1'): [
        ('zcol', 4, 1, Fraction(2, 1)),
        ('zz', 2, 0, Fraction(-4, 1)),
    ],
    (0, 'a2'): [
        ('zcol', 2, 1, Fraction(2, 3)),
    ],
    (0, 'a2b2'): [
        ('hess', 2, 2, Fraction(2, 9)),
        ('zcol', 2, 3, Fraction(-4, 9)),
    ],
    (0, 'b2'): [
        ('hess', 4, 2, Fraction(2, 3)),
        ('hess', 2, 0, Fraction(-2, 3)),
        ('zrow', 2, 1, Fraction(-4, 3)),
        ('zcol', 4, 3, Fraction(-4, 3)),
        ('zcol', 2, 1, Fraction(2, 1)),
        ('zz', 2, 2, Fraction(8, 3)),
    ],
    (1, '1'): [
        ('hess', 4, 1, Fraction(2, 1)),
        ('zrow', 2, 0, Fraction(-4, 1)),
        ('zcol', 4, 2, Fraction(-4, 1)),
        ('zz', 2, 1, Fraction(8, 1)),
    ],
    (1, 'a2'): [
        ('hess', 2, 1, Fraction(2, 3)),
        ('zcol', 2, 2, Fraction(-4, 3)),
    ],
    (1, 'b2'): [
        ('hess', 2, 1, Fraction(-2, 3)),
        ('zcol', 2, 2, Fraction(4, 3)),
    ],
    (2, '1'): [
        ('hess', 2, 0, Fraction(-2, 1)),
        ('zcol', 2, 1, Fraction(4, 1)),
    ],
}

# rot-coupling image channels (lengths in a; rt/tr in
# 1/(8 pi eta a^2), rr in 1/(8 pi eta a^3) units):
#   W_rt(R, h_src) = C0 + h_src C1;  W_tr = reflected
#   transpose at h_tgt;  W_rr height-independent.
CHANNELS_RT = {
    0: [
        ('zcurlgrad', 2, 1, Fraction(2, 3)),
        ('zcurlzcol', 2, 2, Fraction(-4, 3)),
        ('curl', 2, 0, Fraction(1, 1)),
    ],
    1: [
        ('zcurlgrad', 2, 0, Fraction(2, 1)),
        ('zcurlzcol', 2, 1, Fraction(-4, 1)),
    ],
}

CHANNELS_RR = [
    ('iso', 2, 2, Fraction(-2, 1)),
    ('hess', 2, 0, Fraction(-3, 2)),
    ('zrow', 2, 1, Fraction(2, 1)),
    ('zcol', 2, 1, Fraction(1, 1)),
]

def img_terms(dx, dy, rz, h, fx, fy, fz, A2, c4_0, c4_1, c4_2, c4_3, c4_4, c2_0, c2_1, c2_2, c2_3, c2_4):
    """(T0 + h T1 + h^2 T2) f at image displacement (dx,dy,rz),
    source height h, equal radii A2 = a*a. c{b}_{n} = the n-th
    u-derivative (u = r^2) of the radial generator: exact
    (sqrt(u), 1/sqrt(u)) for the full channels, or the screened
    g4/g2 forms for the near-field remainder."""
    t0 = c2_1*fx
    t1 = (4/3)*A2
    t2 = A2*c4_2
    t3 = (8/3)*t2
    t4 = 8*fz
    t5 = c4_2*t4
    t6 = dx*t5
    t7 = 8*fx
    t8 = h*rz
    t9 = c4_2*t8
    t10 = A2**2
    t11 = c2_2*t10
    t12 = (8/9)*t11
    t13 = h**2
    t14 = 4*t13
    t15 = (8/3)*c2_2
    t16 = A2*fy
    t17 = dx*dy
    t18 = t16*t17
    t19 = dx*rz
    t20 = A2*c2_2
    t21 = t20*t4
    t22 = (16/3)*c4_3
    t23 = A2*fz
    t24 = 16*c4_3
    t25 = t23*t24
    t26 = dx**2
    t27 = A2*fx
    t28 = t26*t27
    t29 = rz**2
    t30 = t22*t29
    t31 = t24*t8
    t32 = fy*t17
    t33 = rz**3
    t34 = (32/3)*c4_4
    t35 = t23*t34
    t36 = t33*t35
    t37 = c2_3*t10
    t38 = (16/9)*t37
    t39 = fy*t38
    t40 = (16/3)*t37
    t41 = fz*t40
    t42 = c2_2*t13
    t43 = 8*fy
    t44 = t42*t43
    t45 = t4*t42
    t46 = h*t24
    t47 = fz*t29
    t48 = t46*t47
    t49 = fx*t26
    t50 = t29*t38
    t51 = t42*t7
    t52 = t29*t34
    t53 = fz*t33
    t54 = (32/9)*c2_4*t10
    t55 = t53*t54
    t56 = t29*t54
    t57 = c2_1*fy
    t58 = dy*t5
    t59 = t17*t27
    t60 = dy*rz
    t61 = dy**2
    t62 = t16*t61
    t63 = fx*t17
    t64 = fy*t61
    t65 = 4*fz
    t66 = 8*h
    t67 = c4_2*h
    t68 = dx*t7
    t69 = dy*t43
    t70 = rz*t20
    t71 = t23*t29
    t72 = rz**4
    t73 = t33*t34
    t74 = t29*t46
    t75 = dx*fx
    t76 = dy*fy
    t77 = t33*t54
    ux = -dx*t36 - dx*t48 - dx*t55 + fx*t12 + fx*t3 + fx*t50 - h*t6 + rz*t6 - t0*t1 - t0*t14 - t15*t18 - t15*t28 + t17*t39 - t17*t44 + t18*t22 + t18*t52 + t19*t21 - t19*t25 - t19*t41 + t19*t45 + t22*t28 - t26*t51 + t27*t30 + t28*t52 + t31*t32 + t31*t49 + t32*t56 + t38*t49 + t49*t56 + t7*t9
    uy = -dy*t36 - dy*t48 - dy*t55 + fy*t12 + fy*t3 + fy*t50 - h*t58 + rz*t58 - t1*t57 - t14*t57 - t15*t59 - t15*t62 + t16*t30 - t17*t51 + t21*t60 + t22*t59 + t22*t62 - t25*t60 + t31*t63 + t31*t64 + t38*t63 + t39*t61 - t41*t60 + t43*t9 - t44*t61 + t45*t60 + t52*t59 + t52*t62 + t56*t63 + t56*t64
    uz = -c2_0*t65 + c2_1*t13*t65 + (20/3)*c2_1*t23 + c2_1*t4*t8 + (40/3)*c2_2*t71 + c4_1*t65 - 32*c4_3*t71 - dx*t0*t66 + dx*t27*t73 + dy*t16*t73 - dy*t57*t66 + fx*t19*t40 + fy*t40*t60 - 8/3*fz*t11 - fz*t54*t72 - 24*fz*t9 + t16*t24*t60 + t19*t24*t27 - t19*t51 - t2*t4 + t29*t45 + t29*t5 - t35*t72 - 32/3*t37*t47 - t44*t60 - t46*t53 + t67*t68 + t67*t69 - t68*t70 - t69*t70 + t74*t75 + t74*t76 + t75*t77 + t76*t77
    return ux, uy, uz

def mult_terms(kx, ky, kz, F4, F2, A2, c0x, c0y, c0z, c1x, c1y, c1z, c2x, c2y, c2z):
    """k-space channel application (complex arrays);
    F4 = phi*(-8 pi)/k^4, F2 = phi*4 pi/k^2, channel fields
    c_m spread with strengths h^m f at image points."""
    t0 = 2*F2
    t1 = c2y*t0
    t2 = kx*ky
    t3 = c2z*t0
    t4 = kx*kz
    t5 = 2*F4
    t6 = c0z*t5
    t7 = kx**2
    t8 = c2x*t0
    t9 = A2*F2
    t10 = (2/3)*t9
    t11 = c0y*t10
    t12 = A2*t0
    t13 = c0z*t12
    t14 = c0x*t7
    t15 = c1y*ky
    t16 = 1j*t5
    t17 = t16*t4
    t18 = kz*t16
    t19 = kz**2
    t20 = c1z*t16
    t21 = t19*t20
    t22 = (2/3)*A2*F4
    t23 = kz**3
    t24 = c0z*t23
    t25 = kx*t24
    t26 = c0y*t22
    t27 = t19*t2
    t28 = t14*t19
    t29 = (2/9)*A2**2*F2
    t30 = c0y*t29
    t31 = ky*kz
    t32 = ky**2
    t33 = c0x*t2
    t34 = ky*t24
    t35 = t19*t33
    t36 = t19*t32
    t37 = 4*F2
    t38 = 1j*t37
    t39 = c1x*kx
    t40 = c0z*t19
    t41 = c0z*kz**4
    t42 = t16*t19
    t43 = c0x*kx*t23
    t44 = ky*t23
    ux = -c1x*t18*t7 + kx*t21 + t1*t2 + t10*t14 + t11*t2 - t13*t4 - t15*t17 - t22*t25 + t22*t28 - t25*t29 + t26*t27 + t27*t30 + t28*t29 - t3*t4 - t4*t6 + t7*t8
    uy = -c1x*ky*t17 - c1y*t18*t32 + ky*t21 + t1*t32 + t10*t33 + t11*t32 - t13*t31 + t2*t8 - t22*t34 + t22*t35 + t26*t36 - t29*t34 + t29*t35 - t3*t31 + t30*t36 - t31*t6
    uz = c0x*t12*t4 + c0y*t12*t31 - c0z*t37 + c1z*kz*t38 + t1*t31 - t15*t38 - t15*t42 - t19*t3 + t20*t23 - t22*t41 + t22*t43 + t26*t44 - t29*t41 + t29*t43 + t30*t44 - t38*t39 - t39*t42 + t4*t8 - t40*t5 - 10/3*t40*t9
    return ux, uy, uz

def img_terms_rt(dx, dy, rz, h, fx, fy, fz, c4_0, c4_1, c4_2, c4_3, c4_4, c2_0, c2_1, c2_2, c2_3, c2_4):
    """Angular velocity from image force: (C0 + h C1) f at
    image displacement (dx,dy,rz), SOURCE height h (units of a).
    c{b}_{n}: radial generators as in img_terms."""
    t0 = 2*c2_1
    t1 = c2_1*fy
    t2 = 4*h
    t3 = (8/3)*c2_2
    t4 = fy*rz
    t5 = 8*c2_2*h
    t6 = fx*rz
    t7 = (16/3)*c2_3
    t8 = t6*t7
    t9 = dx*dy
    t10 = dy**2
    t11 = fy*t5
    t12 = rz**2
    t13 = t4*t7
    t14 = dx*fz
    t15 = dx**2
    wx = 2*c2_1*fy*rz + 8*c2_2*dy*fz*h*rz + (8/3)*c2_2*dy*fz + (16/3)*c2_3*dy*fz*t12 - dx*dy*fx*t5 - dy*fz*t0 - t1*t2 - t10*t11 - t10*t13 - t3*t4 - t8*t9
    wy = c2_1*fx*t2 + fx*t15*t5 - rz*t14*t5 + t0*t14 - t0*t6 + t11*t9 - t12*t14*t7 + t13*t9 - t14*t3 + t15*t8 + t3*t6
    wz = 2*c2_1*dy*fx - 2*dx*t1
    return wx, wy, wz


def img_terms_tr(dx, dy, rz, h, tx, ty, tz, c4_0, c4_1, c4_2, c4_3, c4_4, c2_0, c2_1, c2_2, c2_3, c2_4):
    """Velocity from image torque: W_rt(-dx,-dy,rz,h)^T t,
    h = TARGET height (units of a)."""
    t0 = 2*c2_1
    t1 = t0*tz
    t2 = rz*ty
    t3 = h*tx
    t4 = 8*c2_2
    t5 = t3*t4
    t6 = dx*dy
    t7 = rz*tx
    t8 = (16/3)*c2_3
    t9 = t7*t8
    t10 = dx**2
    t11 = (8/3)*c2_2
    t12 = dy**2
    t13 = dy*tx
    t14 = rz**2
    ux = 4*c2_1*h*ty + 8*c2_2*h*t10*ty + (8/3)*c2_2*rz*ty + (16/3)*c2_3*rz*t10*ty - dy*t1 - t0*t2 - t5*t6 - t6*t9
    uy = -4*c2_1*t3 + dx*t1 + h*t4*t6*ty + t0*t7 - t11*t7 - t12*t5 - t12*t9 + t2*t6*t8
    uz = 2*c2_1*dy*tx + 8*c2_2*dx*h*rz*ty + (8/3)*c2_2*dx*ty + (16/3)*c2_3*dx*t14*ty - dx*t0*ty - dy*rz*t5 - t11*t13 - t13*t14*t8
    return ux, uy, uz


def img_terms_rr(dx, dy, rz, tx, ty, tz, c4_0, c4_1, c4_2, c4_3, c4_4, c2_0, c2_1, c2_2, c2_3, c2_4):
    """Angular velocity from image torque (pair part; height-
    independent)."""
    t0 = 7*c2_1
    t1 = c2_2*ty
    t2 = 6*t1
    t3 = dx*dy
    t4 = 2*c2_2*tz
    t5 = rz*t4
    t6 = c2_2*tx
    t7 = 6*t6
    t8 = rz**2
    t9 = 8*t8
    wx = -dx**2*t7 - dx*t5 - t0*tx - t2*t3 - t6*t9
    wy = -dy**2*t2 - dy*t5 - t0*ty - t1*t9 - t3*t7
    wz = -c2_1*tz + 2*c2_2*dx*rz*tx + 2*c2_2*dy*rz*ty - t4*t8
    return wx, wy, wz

def mult_terms_rt(kx, ky, kz, F4, F2, c0x, c0y, c0z, c1x, c1y, c1z):
    """k-space rot-force channels: angular-velocity field from
    image-force channel fields c_m (strengths h^m f at image
    points); F4/F2 as in mult_terms."""
    t0 = 1j*F2
    t1 = kz*t0
    t2 = c0y*t1
    t3 = c0z*ky*t0
    t4 = 2*F2
    t5 = c1x*t4
    t6 = kx*ky
    t7 = ky**2
    t8 = c1y*t4
    t9 = c0x*t1
    t10 = (2/3)*t9
    t11 = (2/3)*t2
    t12 = kz**2
    t13 = kx**2
    wx = -c1z*ky*kz*t4 + t10*t6 + t11*t7 - 2/3*t12*t3 + t2 - t3 + t5*t6 + t7*t8
    wy = (2/3)*1j*F2*c0z*kx*t12 + 1j*F2*c0z*kx + 2*F2*c1z*kx*kz - t10*t13 - t11*t6 - t13*t5 - t6*t8 - t9
    wz = c0x*ky*t0 - c0y*kx*t0
    return wx, wy, wz


def mult_terms_tr(kx, ky, kz, F4, F2, cx, cy, cz):
    """k-space trans-torque channels: TWO velocity fields from
    the image-torque field c (m=0, 1); real-space result is
    sum_m h_target^m interp(u_m)."""
    t0 = 1j*F2
    t1 = kz*t0
    t2 = cy*t1
    t3 = cz*t0
    t4 = kx**2
    t5 = (2/3)*t2
    t6 = cx*t1
    t7 = ky**2
    t8 = cx*ky
    t9 = t0*t8
    t10 = cy*kx
    t11 = t0*t10
    t12 = (2/3)*kz**2
    t13 = 2*F2
    t14 = t13*t8
    t15 = t10*t13
    u0x = (2/3)*1j*F2*cx*kx*ky*kz - ky*t3 - t2 - t4*t5
    u0y = -kx*ky*t5 + kx*t3 + (2/3)*t6*t7 + t6
    u0z = -t11*t12 - t11 + t12*t9 + t9
    u1x = -cy*t13*t4 + kx*t14
    u1y = cx*t13*t7 - ky*t15
    u1z = kz*t14 - kz*t15
    return u0x, u0y, u0z, u1x, u1y, u1z


def mult_terms_rr(kx, ky, kz, F4, F2, cx, cy, cz):
    """k-space rot-rot channel: angular-velocity field from the
    image-torque field c."""
    t0 = F2*cy
    t1 = (3/2)*t0
    t2 = kx*ky
    t3 = (1/2)*F2*cz*kz
    t4 = F2*cx
    t5 = (3/2)*t4
    t6 = kz**2
    t7 = 2*t6
    t8 = (1/2)*kz
    wx = kx**2*t5 + kx*t3 + t1*t2 + t4*t7
    wy = ky**2*t1 + ky*t3 + t0*t7 + t2*t5
    wz = (1/2)*F2*cz*t6 - kx*t4*t8 - ky*t0*t8
    return wx, wy, wz

# d^n/du^n closed forms; eval with {erfc, exp, sqrt, pi, u, xi}
RADIAL_SRC = {
    'g4': [
        'math.sqrt(u)*math.erfc(math.sqrt(u)*xi) - math.exp(-u*xi**2)/(math.sqrt(math.pi)*xi)',
        '(1/2)*math.erfc(math.sqrt(u)*xi)/math.sqrt(u)',
        '-1/2*xi*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u) - 1/4*math.erfc(math.sqrt(u)*xi)/u**(3/2)',
        '(1/2)*xi**3*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u) + (3/4)*xi*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u**2) + (3/8)*math.erfc(math.sqrt(u)*xi)/u**(5/2)',
        '(1/16)*(-8*math.pi*u**(17/2)*xi**5 - 20*math.pi*u**(15/2)*xi**3 - 30*math.pi*u**(13/2)*xi - 15*math.pi**(3/2)*u**6*math.exp(u*xi**2)*math.erfc(math.sqrt(u)*xi))*math.exp(-u*xi**2)/(math.pi**(3/2)*u**(19/2))',
    ],
    'g2': [
        '-xi*math.exp(-u*xi**2)/math.sqrt(math.pi) + math.erfc(math.sqrt(u)*xi)/math.sqrt(u)',
        'xi**3*math.exp(-u*xi**2)/math.sqrt(math.pi) - xi*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u) - 1/2*math.erfc(math.sqrt(u)*xi)/u**(3/2)',
        '-xi**5*math.exp(-u*xi**2)/math.sqrt(math.pi) + xi**3*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u) + (3/2)*xi*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u**2) + (3/4)*math.erfc(math.sqrt(u)*xi)/u**(5/2)',
        'xi**7*math.exp(-u*xi**2)/math.sqrt(math.pi) - xi**5*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u) - 5/2*xi**3*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u**2) - 15/4*xi*math.exp(-u*xi**2)/(math.sqrt(math.pi)*u**3) - 15/8*math.erfc(math.sqrt(u)*xi)/u**(7/2)',
        '(1/16)*(-16*math.pi**2*u**(29/2)*xi**9 + 16*math.pi**2*u**(27/2)*xi**7 + 56*math.pi**2*u**(25/2)*xi**5 + 140*math.pi**2*u**(23/2)*xi**3 + 210*math.pi**2*u**(21/2)*xi + 105*math.pi**(5/2)*u**10*math.exp(u*xi**2)*math.erfc(math.sqrt(u)*xi))*math.exp(-u*xi**2)/(math.pi**(5/2)*u**(29/2))',
    ],
    'e4': [
        'math.sqrt(u)',
        '(1/2)/math.sqrt(u)',
        '-(1/4)/u**(3/2)',
        '(3/8)/u**(5/2)',
        '-(15/16)/u**(7/2)',
    ],
    'e2': [
        '1/math.sqrt(u)',
        '-(1/2)/u**(3/2)',
        '(3/4)/u**(5/2)',
        '-(15/8)/u**(7/2)',
        '(105/16)/u**(9/2)',
    ],
}