// GENERATED by rigidmultiblobswall_tpu_torch/ops/_emit_wall_cuh.py from
// ops/_wall_channels_gen.py (img_terms) -- do not edit.
//
// (T0 + h T1 + h^2 T2) f of the Swan-Brady image channels at the image
// displacement (dx, dy, rz), source height h, equal radii A2, from the
// ten radial values c4_0..c4_4, c2_0..c2_4 (see the Python docstring).

#pragma once

namespace wallk {

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

}  // namespace wallk
