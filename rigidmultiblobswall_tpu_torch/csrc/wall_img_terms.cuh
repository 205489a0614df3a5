// GENERATED by rigidmultiblobswall_tpu_torch/ops/_emit_wall_cuh.py from
// ops/_wall_channels_gen.py (img_terms, img_terms_rt, img_terms_tr, img_terms_rr)
// -- do not edit. See the Python docstrings.

#pragma once

namespace wallk {

// img_terms (kernel K7): (T0 + h T1 + h^2 T2) f of the Swan-Brady image
// channels at the image displacement (dx, dy, rz), source height h, equal
// radii A2; of the ten radial values c4_0..c4_4, c2_0..c2_4 it reads c4_1,
// c4_2, c4_3, c4_4, c2_0, c2_1, c2_2, c2_3, c2_4.
template <typename T>
__device__ __forceinline__ void img_terms(T dx, T dy, T rz, T h, T fx, T fy, T fz, T A2, T c4_0, T c4_1, T c4_2, T c4_3, T c4_4, T c2_0, T c2_1, T c2_2, T c2_3, T c2_4,
    T& ux_out, T& uy_out, T& uz_out) {
  const T t0 = (c2_1 * fx);
  const T t1 = (T((4.0 / 3.0)) * A2);
  const T t2 = (A2 * c4_2);
  const T t3 = (T((8.0 / 3.0)) * t2);
  const T t4 = (T(8.0) * fz);
  const T t5 = (c4_2 * t4);
  const T t6 = (dx * t5);
  const T t7 = (T(8.0) * fx);
  const T t8 = (h * rz);
  const T t9 = (c4_2 * t8);
  const T t10 = (A2*A2);
  const T t11 = (c2_2 * t10);
  const T t12 = (T((8.0 / 9.0)) * t11);
  const T t13 = (h*h);
  const T t14 = (T(4.0) * t13);
  const T t15 = (T((8.0 / 3.0)) * c2_2);
  const T t16 = (A2 * fy);
  const T t17 = (dx * dy);
  const T t18 = (t16 * t17);
  const T t19 = (dx * rz);
  const T t20 = (A2 * c2_2);
  const T t21 = (t20 * t4);
  const T t22 = (T((16.0 / 3.0)) * c4_3);
  const T t23 = (A2 * fz);
  const T t24 = (T(16.0) * c4_3);
  const T t25 = (t23 * t24);
  const T t26 = (dx*dx);
  const T t27 = (A2 * fx);
  const T t28 = (t26 * t27);
  const T t29 = (rz*rz);
  const T t30 = (t22 * t29);
  const T t31 = (t24 * t8);
  const T t32 = (fy * t17);
  const T t33 = (rz*rz*rz);
  const T t34 = (T((32.0 / 3.0)) * c4_4);
  const T t35 = (t23 * t34);
  const T t36 = (t33 * t35);
  const T t37 = (c2_3 * t10);
  const T t38 = (T((16.0 / 9.0)) * t37);
  const T t39 = (fy * t38);
  const T t40 = (T((16.0 / 3.0)) * t37);
  const T t41 = (fz * t40);
  const T t42 = (c2_2 * t13);
  const T t43 = (T(8.0) * fy);
  const T t44 = (t42 * t43);
  const T t45 = (t4 * t42);
  const T t46 = (h * t24);
  const T t47 = (fz * t29);
  const T t48 = (t46 * t47);
  const T t49 = (fx * t26);
  const T t50 = (t29 * t38);
  const T t51 = (t42 * t7);
  const T t52 = (t29 * t34);
  const T t53 = (fz * t33);
  const T t54 = ((T((32.0 / 9.0)) * c2_4) * t10);
  const T t55 = (t53 * t54);
  const T t56 = (t29 * t54);
  const T t57 = (c2_1 * fy);
  const T t58 = (dy * t5);
  const T t59 = (t17 * t27);
  const T t60 = (dy * rz);
  const T t61 = (dy*dy);
  const T t62 = (t16 * t61);
  const T t63 = (fx * t17);
  const T t64 = (fy * t61);
  const T t65 = (T(4.0) * fz);
  const T t66 = (T(8.0) * h);
  const T t67 = (c4_2 * h);
  const T t68 = (dx * t7);
  const T t69 = (dy * t43);
  const T t70 = (rz * t20);
  const T t71 = (t23 * t29);
  const T t72 = (rz*rz*rz*rz);
  const T t73 = (t33 * t34);
  const T t74 = (t29 * t46);
  const T t75 = (dx * fx);
  const T t76 = (dy * fy);
  const T t77 = (t33 * t54);
  const T ux = (((((((((((((((((((((((((((((((-dx) * t36) - (dx * t48)) - (dx * t55)) + (fx * t12)) + (fx * t3)) + (fx * t50)) - (h * t6)) + (rz * t6)) - (t0 * t1)) - (t0 * t14)) - (t15 * t18)) - (t15 * t28)) + (t17 * t39)) - (t17 * t44)) + (t18 * t22)) + (t18 * t52)) + (t19 * t21)) - (t19 * t25)) - (t19 * t41)) + (t19 * t45)) + (t22 * t28)) - (t26 * t51)) + (t27 * t30)) + (t28 * t52)) + (t31 * t32)) + (t31 * t49)) + (t32 * t56)) + (t38 * t49)) + (t49 * t56)) + (t7 * t9));
  const T uy = (((((((((((((((((((((((((((((((-dy) * t36) - (dy * t48)) - (dy * t55)) + (fy * t12)) + (fy * t3)) + (fy * t50)) - (h * t58)) + (rz * t58)) - (t1 * t57)) - (t14 * t57)) - (t15 * t59)) - (t15 * t62)) + (t16 * t30)) - (t17 * t51)) + (t21 * t60)) + (t22 * t59)) + (t22 * t62)) - (t25 * t60)) + (t31 * t63)) + (t31 * t64)) + (t38 * t63)) + (t39 * t61)) - (t41 * t60)) + (t43 * t9)) - (t44 * t61)) + (t45 * t60)) + (t52 * t59)) + (t52 * t62)) + (t56 * t63)) + (t56 * t64));
  const T uz = (((((((((((((((((((((((((((((((((((-c2_0) * t65) + ((c2_1 * t13) * t65)) + ((T((20.0 / 3.0)) * c2_1) * t23)) + ((c2_1 * t4) * t8)) + ((T((40.0 / 3.0)) * c2_2) * t71)) + (c4_1 * t65)) - ((T(32.0) * c4_3) * t71)) - ((dx * t0) * t66)) + ((dx * t27) * t73)) + ((dy * t16) * t73)) - ((dy * t57) * t66)) + ((fx * t19) * t40)) + ((fy * t40) * t60)) - ((T((8.0 / 3.0)) * fz) * t11)) - ((fz * t54) * t72)) - ((T(24.0) * fz) * t9)) + ((t16 * t24) * t60)) + ((t19 * t24) * t27)) - (t19 * t51)) - (t2 * t4)) + (t29 * t45)) + (t29 * t5)) - (t35 * t72)) - ((T((32.0 / 3.0)) * t37) * t47)) - (t44 * t60)) - (t46 * t53)) + (t67 * t68)) + (t67 * t69)) - (t68 * t70)) - (t69 * t70)) + (t74 * t75)) + (t74 * t76)) + (t75 * t77)) + (t76 * t77));
  ux_out = ux;
  uy_out = uy;
  uz_out = uz;
}

// img_terms_rt (kernel K8): angular velocity from an image force, (C0 + h
// C1) f at the image displacement (dx, dy, rz), h the SOURCE height; of the
// ten radial values c4_0..c4_4, c2_0..c2_4 it reads c2_1, c2_2, c2_3.
template <typename T>
__device__ __forceinline__ void img_terms_rt(T dx, T dy, T rz, T h, T fx, T fy, T fz, T c4_0, T c4_1, T c4_2, T c4_3, T c4_4, T c2_0, T c2_1, T c2_2, T c2_3, T c2_4,
    T& wx_out, T& wy_out, T& wz_out) {
  const T t0 = (T(2.0) * c2_1);
  const T t1 = (c2_1 * fy);
  const T t2 = (T(4.0) * h);
  const T t3 = (T((8.0 / 3.0)) * c2_2);
  const T t4 = (fy * rz);
  const T t5 = ((T(8.0) * c2_2) * h);
  const T t6 = (fx * rz);
  const T t7 = (T((16.0 / 3.0)) * c2_3);
  const T t8 = (t6 * t7);
  const T t9 = (dx * dy);
  const T t10 = (dy*dy);
  const T t11 = (fy * t5);
  const T t12 = (rz*rz);
  const T t13 = (t4 * t7);
  const T t14 = (dx * fz);
  const T t15 = (dx*dx);
  const T wx = (((((((((((((T(2.0) * c2_1) * fy) * rz) + (((((T(8.0) * c2_2) * dy) * fz) * h) * rz)) + (((T((8.0 / 3.0)) * c2_2) * dy) * fz)) + ((((T((16.0 / 3.0)) * c2_3) * dy) * fz) * t12)) - (((dx * dy) * fx) * t5)) - ((dy * fz) * t0)) - (t1 * t2)) - (t10 * t11)) - (t10 * t13)) - (t3 * t4)) - (t8 * t9));
  const T wy = ((((((((((((c2_1 * fx) * t2) + ((fx * t15) * t5)) - ((rz * t14) * t5)) + (t0 * t14)) - (t0 * t6)) + (t11 * t9)) - ((t12 * t14) * t7)) + (t13 * t9)) - (t14 * t3)) + (t15 * t8)) + (t3 * t6));
  const T wz = ((((T(2.0) * c2_1) * dy) * fx) - ((T(2.0) * dx) * t1));
  wx_out = wx;
  wy_out = wy;
  wz_out = wz;
}

// img_terms_tr (kernel K8): velocity from an image torque, W_rt(-dx, -dy,
// rz, h)^T t, h the TARGET height; of the ten radial values c4_0..c4_4,
// c2_0..c2_4 it reads c2_1, c2_2, c2_3.
template <typename T>
__device__ __forceinline__ void img_terms_tr(T dx, T dy, T rz, T h, T tx, T ty, T tz, T c4_0, T c4_1, T c4_2, T c4_3, T c4_4, T c2_0, T c2_1, T c2_2, T c2_3, T c2_4,
    T& ux_out, T& uy_out, T& uz_out) {
  const T t0 = (T(2.0) * c2_1);
  const T t1 = (t0 * tz);
  const T t2 = (rz * ty);
  const T t3 = (h * tx);
  const T t4 = (T(8.0) * c2_2);
  const T t5 = (t3 * t4);
  const T t6 = (dx * dy);
  const T t7 = (rz * tx);
  const T t8 = (T((16.0 / 3.0)) * c2_3);
  const T t9 = (t7 * t8);
  const T t10 = (dx*dx);
  const T t11 = (T((8.0 / 3.0)) * c2_2);
  const T t12 = (dy*dy);
  const T t13 = (dy * tx);
  const T t14 = (rz*rz);
  const T ux = ((((((((((T(4.0) * c2_1) * h) * ty) + ((((T(8.0) * c2_2) * h) * t10) * ty)) + (((T((8.0 / 3.0)) * c2_2) * rz) * ty)) + ((((T((16.0 / 3.0)) * c2_3) * rz) * t10) * ty)) - (dy * t1)) - (t0 * t2)) - (t5 * t6)) - (t6 * t9));
  const T uy = (((((((((T(-4.0) * c2_1) * t3) + (dx * t1)) + (((h * t4) * t6) * ty)) + (t0 * t7)) - (t11 * t7)) - (t12 * t5)) - (t12 * t9)) + ((t2 * t6) * t8));
  const T uz = ((((((((((T(2.0) * c2_1) * dy) * tx) + (((((T(8.0) * c2_2) * dx) * h) * rz) * ty)) + (((T((8.0 / 3.0)) * c2_2) * dx) * ty)) + ((((T((16.0 / 3.0)) * c2_3) * dx) * t14) * ty)) - ((dx * t0) * ty)) - ((dy * rz) * t5)) - (t11 * t13)) - ((t13 * t14) * t8));
  ux_out = ux;
  uy_out = uy;
  uz_out = uz;
}

// img_terms_rr (kernel K8): angular velocity from an image torque (height
// independent); of the ten radial values c4_0..c4_4, c2_0..c2_4 it reads
// c2_1, c2_2.
template <typename T>
__device__ __forceinline__ void img_terms_rr(T dx, T dy, T rz, T tx, T ty, T tz, T c4_0, T c4_1, T c4_2, T c4_3, T c4_4, T c2_0, T c2_1, T c2_2, T c2_3, T c2_4,
    T& wx_out, T& wy_out, T& wz_out) {
  const T t0 = (T(7.0) * c2_1);
  const T t1 = (c2_2 * ty);
  const T t2 = (T(6.0) * t1);
  const T t3 = (dx * dy);
  const T t4 = ((T(2.0) * c2_2) * tz);
  const T t5 = (rz * t4);
  const T t6 = (c2_2 * tx);
  const T t7 = (T(6.0) * t6);
  const T t8 = (rz*rz);
  const T t9 = (T(8.0) * t8);
  const T wx = ((((((-(dx*dx)) * t7) - (dx * t5)) - (t0 * tx)) - (t2 * t3)) - (t6 * t9));
  const T wy = ((((((-(dy*dy)) * t2) - (dy * t5)) - (t0 * ty)) - (t1 * t9)) - (t3 * t7));
  const T wz = (((((-c2_1) * tz) + ((((T(2.0) * c2_2) * dx) * rz) * tx)) + ((((T(2.0) * c2_2) * dy) * rz) * ty)) - (t4 * t8));
  wx_out = wx;
  wy_out = wy;
  wz_out = wz;
}

}  // namespace wallk
